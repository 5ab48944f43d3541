"""The port's data parallelism across processes, on the CPU over gloo: ranks
spawned by `torch.multiprocessing` (tests/torch_multiprocess_worker.py)
join one process group, as `torchrun` ranks join NCCL on the card.

  * the collectives: the JAX package's multi-process assertions
    (tests/test_multiprocess.py `_WORKER`: reduce_dict, all_gather_objects,
    comm.synchronize, the SmoothedValue sync) on the port's;
  * a 2-rank fp32 train step against JAX's single-process step on the
    concatenated global batch (rank-major rows, the world-of-one label
    layout; a deduped channel's unique rows the ranks' blocks): plain
    contrastive, finetune_ot.json's OT branch (a sum over the batch) and
    clip_event_full.json's multiattention branch (a sum over images, its
    role texts deduped), and gradient accumulation (2 microbatches, the
    description texts deduped). SGD at lr 0.1 with no clip, so a gradient
    off by any factor moves the params visibly. Every loss term within
    1e-5, grad_norm within 1e-5 relative, the updated params within 1e-5
    (fp32 on both sides; only reduction orders differ), and the ranks'
    params and metrics bit for bit equal to each other;
  * the M2E2 eval (plain, and with its threshold sweep over the even
    indices) and the matching eval sharded over the ranks equal to the
    same call on one shard, on every rank (7 images: the loader's
    wrap-around row is dropped);
  * `run_embed` sharded: rank-tagged shards whose ids cover every image
    and text once, features within 1e-6 of a one-process run;
  * ZeRO-1 and FSDP (`parallel/sharding.py`), Adam with the clip at 1.0:
    the sharded 2-rank steps (contrastive and OT under both, multiattention
    under FSDP; ZeRO with two accumulated microbatches and with bf16 first
    moments; FSDP with two steps in one `make_multi_step` dispatch)
    against JAX's steps on the global batches (loss, grad_norm, every
    param within 1e-5, every moment within 1e-5 of its largest value) and
    against the plain 2-rank step of the same spawn (within 1e-6 of the
    largest value of each tree); each rank's shard sizes; the checkpoint a
    sharded run writes, read by the port at a world of one and by JAX's
    `import_initial_checkpoint` with equal tensors; a ZeRO state saved at 2
    ranks, resumed at a world of one and stepped, against JAX's run of the
    three steps (`tests/test_zero.py::test_cross_topology_resume`); a
    world-of-one file resumed at 2 ranks under FSDP.

Marked `slow` (not in tier-1, each spawns its own ranks): the 4-rank KL
step (its labels are [B, 4·B·D] rows of the global layout) against JAX,
the tiny-ResNet `sync_bn` 2-rank step against JAX's `set_bn_mode("batch")`
step on the global batch, and `python -m clip_event_tpu_torch.train` on 2
ranks against one process at twice the batch."""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models import resnet as JR  # noqa: E402
from clip_event_tpu.models.convert import params_from_state_dict  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import state_dict_from_params  # noqa: E402
from tests import torch_multiprocess_worker as W  # noqa: E402
from tests.fixtures import make_m2e2_fixture, make_voa_fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B_LOCAL = 2, 2
STEP_CASES = ("contrastive", "ot", "multiattention")
TEXTS = [f"a protest march in city {i}" for i in range(7)]
TOL = 1e-5
# the sharded steps: (mode, case) held against JAX and the plain 2-rank step
SHARDED_STEPS = (("zero", "contrastive"), ("fsdp", "contrastive"), ("zero", "ot"), ("fsdp", "ot"),
                 ("fsdp", "multiattention"))
SHARDED_CASES = tuple(f"{m}:{c}" for m, c in SHARDED_STEPS) + tuple(
    f"plain:{c}" for c in STEP_CASES) + ("zero:accum_dedupe", "zero:bf16", "fsdp:multi_step",
                                         "fsdp:from_one")


def _spawn(out, world, cases, b_local=B_LOCAL, fixtures=None, texts=()):
    os.makedirs(out, exist_ok=True)
    mp.spawn(W.main, args=(world, str(out), tuple(cases), b_local, fixtures, tuple(texts)),
             nprocs=world, join=True)
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_fixtures")
    os.makedirs(root / "m2e2")
    return {"m2e2": make_m2e2_fixture(str(root / "m2e2"), num_images=7),
            "voa": make_voa_fixture(str(root / "voa"), num_docs=5)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, fixtures):
    """One spawn of two ranks for every tier-1 case."""
    out = tmp_path_factory.mktemp("dp_ranks")
    cases = ("comm",) + STEP_CASES + ("accum_dedupe", "evals", "embed") + SHARDED_CASES
    return _spawn(out, WORLD, cases, fixtures=fixtures, texts=TEXTS), out


def _jax_step(case, world=WORLD, b_local=B_LOCAL):
    """JAX's single-process step of the case on the global batch, from the
    port's init carried over by the state dict: (metrics, state dict)."""
    tcfg = T.CLIPConfig(**W.model_dict(case))
    jcfg = J.CLIPConfig(**W.model_dict(case))
    params, _ = W.init_params(case)
    np_params = params_from_state_dict(state_dict_from_params(params, tcfg), jcfg)[0]
    opt = JO.build_optimizer("sgd", JO.build_schedule("none", W.LR, 1), grad_clip_norm=None)
    kw = dict(W.step_kwargs(case), donate=False, compute_dtype=jnp.float32, remat=False)
    if kw.get("alignment"):
        kw["use_pallas_ot"] = False  # the JAX package's plain solver on the CPU
    if case == "accum_dedupe":
        micro = [W.make_batches(case, world, b_local, 20 + k)[0] for k in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        step = JT.make_accum_step(jcfg, opt, 2, **kw)
    else:
        batch = W.make_batches(case, world, b_local, 10)[0]
        step = JT.make_train_step(jcfg, opt, **kw)
    state = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), opt)
    JR.set_bn_mode("batch" if case == "sync_bn" else "frozen")
    try:
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    finally:
        JR.set_bn_mode("frozen")
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_params(jax.tree.map(np.asarray, state.params), tcfg))


def _check_step(results, case, **kw):
    """The ranks agree bit for bit; rank 0 agrees with JAX within TOL."""
    (m0, sd0), others = results[0][case], [r[case] for r in results[1:]]
    for m, sd in others:
        assert m == m0
        assert all(np.array_equal(sd[k], sd0[k]) for k in sd0)
    jm, jsd = _jax_step(case, **kw)
    assert set(m0) == set(jm)
    for k in jm:
        if k == "grad_norm":
            np.testing.assert_allclose(m0[k], jm[k], rtol=TOL, err_msg=k)
        else:
            np.testing.assert_allclose(m0[k], jm[k], atol=TOL, rtol=0, err_msg=k)
    assert m0["finite"] == 1.0
    assert sd0.keys() == jsd.keys()
    for k in jsd:
        np.testing.assert_allclose(sd0[k], jsd[k], atol=TOL, rtol=0, err_msg=k)
    params, tcfg = W.init_params(case)
    init = state_dict_from_params(params, tcfg)
    # the step moved the params: a gradient off by a factor would show
    assert max(np.abs(sd0[k] - init[k]).max() for k in init) > 1e-3
    return m0


def test_collectives_hold_the_jax_workers_assertions(ranks):
    results, _ = ranks
    assert [r["comm"] for r in results] == ["ok", "ok"]
    assert [r["mesh"] for r in results] == [(0, 2, "cpu"), (1, 2, "cpu")]


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_rank_step_matches_jax_on_the_global_batch(ranks, case):
    m = _check_step(ranks[0], case)
    if case == "ot":
        assert m["loss_ot"] > 0
    if case == "multiattention":
        assert m["loss_bbox"] > 0 and m["loss_arg"] > 0


def test_two_rank_accumulated_step_matches_jax(ranks):
    """Two microbatches a step, each a global microbatch of the ranks' k-th
    rows; the description texts deduped into the ranks' blocks."""
    _check_step(ranks[0], "accum_dedupe")


@pytest.mark.parametrize("name", ["m2e2", "m2e2_sweep", "matching"])
def test_sharded_evals_equal_the_single_process_eval(ranks, name):
    results, _ = ranks
    sharded, single = results[0]["evals"][name]
    assert sharded == single
    assert results[1]["evals"][name][0] == sharded
    n = sharded.get("num_images", sharded.get("num_pairs"))
    assert n == (7 if name.startswith("m2e2") else 5)


def test_sharded_embed_covers_every_id_once(ranks, fixtures, tmp_path):
    from clip_event_tpu_torch.embed import run_embed

    results, out = ranks
    embed_dir = os.path.join(out, "embed")
    with open(os.path.join(embed_dir, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert results[0]["embed"] == results[1]["embed"]
    assert {k: v["count"] for k, v in results[0]["embed"].items()} == {"images": 7, "texts": 7}
    params, cfg = W.init_params("embed")
    single = os.path.join(tmp_path, "single")
    run_embed({"output_dir": single, "image_dir": fixtures["m2e2"]["image_dir"], "texts": TEXTS,
               "batch_size": 2, "shard_size": 2, "num_workers": 2}, params, cfg, device="cpu")
    for kind in ("images", "texts"):
        shards = manifest[kind]["shards"]
        assert {s.split("-")[-2] for s in shards} == {"r00", "r01"}
        ids, feats = [], []
        for name in shards:
            with np.load(os.path.join(embed_dir, name)) as z:
                ids += z["ids"].tolist()
                feats.append(z["features"])
        assert len(ids) == len(set(ids)) == manifest[kind]["count"] == 7
        got = dict(zip(ids, np.concatenate(feats)))
        want = {}
        for name in os.listdir(single):
            if name.startswith("image-" if kind == "images" else "text-"):
                with np.load(os.path.join(single, name)) as z:
                    want.update(zip(z["ids"].tolist(), z["features"]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)


@pytest.mark.slow
def test_four_rank_kl_step_matches_jax(tmp_path):
    """Four ranks of one row each under the KL loss, whose label rows span
    the global batch's columns; the collectives at a world of four."""
    results = _spawn(tmp_path, 4, ("comm", "kl"), b_local=1)
    assert [r["comm"] for r in results] == ["ok"] * 4
    _check_step(results, "kl", world=4, b_local=1)


@pytest.mark.slow
def test_sync_bn_two_rank_step_matches_jax(tmp_path):
    """A tiny ResNet whose BatchNorm takes the global batch's statistics:
    the all-reduced sums and its summed cotangents against JAX's batch
    mode on the global batch."""
    results = _spawn(tmp_path, 2, ("sync_bn",))
    _check_step(results, "sync_bn")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.slow
def test_two_rank_train_cli_matches_one_process(tmp_path):
    """`python -m clip_event_tpu_torch.train --device cpu` as two ranks of
    torchrun's environment (batch 2 each) against one process at batch 4:
    the same global batches (in another row order), so the same epoch
    losses within 1e-5 and the same checkpoint; rank 0 writes the scalars,
    config and checkpoint."""
    from clip_event_tpu.engine.checkpoint import export_torch_checkpoint
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint

    voa = make_voa_fixture(str(tmp_path / "voa"), num_docs=6, images_per_doc=2)
    jcfg = J.CLIPConfig(**W.VIT)
    pth = str(tmp_path / "boot.pth")
    export_torch_checkpoint(pth, J.init_params(jax.random.PRNGKey(3), jcfg), jcfg, epoch=0, task="boot")
    base = {"task": "dp", "constrastive_loss": "ce", "posneg_descriptions_json": voa["descriptions_json"],
            "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
            "max_epoch": 2, "lr": 1e-4, "optimizer": "adam", "lr_scheduler": "warmup",
            "compute_dtype": "float32", "remat": False, "num_workers": 2, "jit": True,
            "begin_ckpt": pth, "seed": 5}
    env = dict(os.environ, PYTHONPATH=REPO, CLIP_EVENT_NATIVE="0")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    runs = {}
    for name, world, batch in (("one", 1, 4), ("two", 2, 2)):
        cfg = dict(base, batch_size=batch, ckpt_dir=str(tmp_path / name / "ckpt"),
                   tb_log_dir=str(tmp_path / name / "logs"))
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        cmd = [sys.executable, "-m", "clip_event_tpu_torch.train", "--cfg", str(path), "--device", "cpu"]
        if world == 1:
            procs = [subprocess.Popen(cmd, env=env, cwd=REPO)]
        else:
            port = str(_free_port())
            procs = [subprocess.Popen(cmd, cwd=REPO, env=dict(
                env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=port)) for r in range(world)]
        assert [p.wait(timeout=600) for p in procs] == [0] * world
        runs[name] = cfg
    scalars = {}
    for name, cfg in runs.items():
        with open(os.path.join(cfg["tb_log_dir"], "dp", "tensorboard", "scalars.jsonl")) as fh:
            scalars[name] = {(r["tag"], r["step"]): r["value"] for r in map(json.loads, fh)}
    assert scalars["one"].keys() == scalars["two"].keys()
    assert ("train_loss", 1) in scalars["one"]
    for key, value in scalars["one"].items():
        np.testing.assert_allclose(scalars["two"][key], value, atol=1e-5, rtol=0, err_msg=str(key))
    ckpt = {name: restore_checkpoint(os.path.join(cfg["ckpt_dir"], "dp", "dp_1"))[0]
            for name, cfg in runs.items()}
    tcfg = T.CLIPConfig(**W.VIT)
    a, b = (state_dict_from_params(ckpt[n], tcfg) for n in ("one", "two"))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=0, err_msg=k)


# ------------------------------------------------------------ ZeRO-1 / FSDP


def _adam_moments(jstate):
    """(mu, nu) of JAX's Adam state, numpy trees in the params' layout."""
    adam = [t for t in jax.tree.leaves(jstate.opt_state, is_leaf=lambda x: hasattr(x, "_fields"))
            if hasattr(t, "mu")][0]
    return tuple(jax.tree.map(lambda x: np.asarray(x).astype(np.float32), t) for t in (adam.mu, adam.nu))


_JAX_ADAM = {}


def _jax_adam(case, steps=1, moment_dtype=None):
    """JAX's Adam steps (clip 1.0) of the case on the global batches of
    `W.ADAM_SEEDS` (the accumulated case: its two global microbatches),
    from the port's init: a record after each step, shaped like
    `W.state_record` (metrics beside it)."""
    key = (case, moment_dtype)
    if key in _JAX_ADAM and len(_JAX_ADAM[key]) >= steps:
        return _JAX_ADAM[key][:steps]
    base = case if case in ("ot", "multiattention", "accum_dedupe") else "contrastive"
    tcfg = T.CLIPConfig(**W.model_dict(base))
    jcfg = J.CLIPConfig(**W.model_dict(base))
    params, _ = W.init_params(base)
    np_params = params_from_state_dict(state_dict_from_params(params, tcfg), jcfg)[0]
    opt = JO.build_optimizer("adam", JO.build_schedule("none", W.ADAM_LR, 1), grad_clip_norm=1.0,
                             moment_dtype=moment_dtype)
    kw = dict(W.step_kwargs(base), donate=False, compute_dtype=jnp.float32, remat=False)
    if kw.get("alignment"):
        kw["use_pallas_ot"] = False  # the JAX package's plain solver on the CPU
    if base == "accum_dedupe":
        micro = [W.make_batches(base, WORLD, B_LOCAL, 20 + k)[0] for k in range(2)]
        batches = [{k: np.stack([m[k] for m in micro]) for k in micro[0]}]
        step = JT.make_accum_step(jcfg, opt, 2, **kw)
    else:
        batches = [W.make_batches(base, WORLD, B_LOCAL, seed)[0] for seed in W.ADAM_SEEDS[:steps]]
        step = JT.make_train_step(jcfg, opt, **kw)
    state = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), opt)
    records = []
    for batch in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        mu, nu = _adam_moments(state)
        records.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": state_dict_from_params(jax.tree.map(np.asarray, state.params), tcfg),
            "mu": state_dict_from_params(mu, tcfg), "nu": state_dict_from_params(nu, tcfg),
        })
    _JAX_ADAM[key] = records
    return records


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "grad_norm":
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
    assert got["finite"] == 1.0


def _close_state(got, want, rel=None):
    """Every param within TOL and every moment within TOL of its largest
    value (JAX); with `rel`, every param and moment within `rel` of the
    largest value of its tree (the plain step)."""
    for tree in ("params", "mu", "nu"):
        a, b = got[tree], want[tree]
        assert a.keys() == b.keys()
        top = max(np.abs(b[k]).max() for k in b)
        for k in b:
            if rel is not None:
                atol = rel * top
            else:
                atol = TOL if tree == "params" else TOL * max(np.abs(b[k]).max(), 1e-30)
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=f"{tree} {k}")


def _ranks_agree(results, case):
    """Every rank gathered the same state and read the same metrics."""
    r0 = results[0][case]
    for r in results[1:]:
        assert r[case]["metrics"] == r0["metrics"]
        for tree in ("params", "mu", "nu"):
            assert all(np.array_equal(r[case][tree][k], r0[tree][k]) for k in r0[tree])
    return r0


@pytest.mark.parametrize("mode,case", SHARDED_STEPS)
def test_sharded_step_matches_jax_and_the_plain_step(ranks, mode, case):
    results, _ = ranks
    got = _ranks_agree(results, f"{mode}:{case}")
    rec = got.get("step1", got)
    jax_rec = _jax_adam(case)[0]
    _close_metrics(got["metrics"], jax_rec["metrics"])
    _close_state(rec, jax_rec)
    plain = results[0][f"plain:{case}"]
    for k, v in plain["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, atol=0, err_msg=k)
    _close_state(rec, plain, rel=1e-6)
    # the clip is on (the global norm is over 1) and Adam moved the params
    assert got["metrics"]["grad_norm"] > 1.0 and rec["count"] == 1
    params, tcfg = W.init_params(case)
    init = state_dict_from_params(params, tcfg)
    assert max(np.abs(rec["params"][k] - init[k]).max() for k in init) > 0.5 * W.ADAM_LR


def test_zero_accumulated_step_matches_jax(ranks):
    got = _ranks_agree(ranks[0], "zero:accum_dedupe")
    jax_rec = _jax_adam("accum_dedupe")[0]
    _close_metrics(got["metrics"], jax_rec["metrics"])
    _close_state(got, jax_rec)


def test_zero_bf16_moments_match_jax(ranks):
    """bf16 first moments: the stored moment's decay rounded as optax
    rounds it; mu compared within one bf16 ulp of its largest value."""
    got = _ranks_agree(ranks[0], "zero:bf16")
    jax_rec = _jax_adam("contrastive", moment_dtype="bfloat16")[0]
    _close_metrics(got["metrics"], jax_rec["metrics"])
    _close_state({k: got[k] for k in ("params", "nu")} | {"mu": jax_rec["mu"]}, jax_rec)
    for k, want in jax_rec["mu"].items():
        np.testing.assert_allclose(got["mu"][k], want, atol=2.0**-8 * np.abs(want).max(), rtol=0,
                                   err_msg=k)


def test_fsdp_multi_step_dispatch_matches_jax(ranks):
    """Two steps in one `make_multi_step` dispatch against JAX's two steps."""
    got = _ranks_agree(ranks[0], "fsdp:multi_step")
    jax_recs = _jax_adam("contrastive", steps=2)
    for j, rec in enumerate(jax_recs):
        _close_metrics({k: v[j] for k, v in got["metrics"].items()}, rec["metrics"])
    assert got["count"] == 2
    _close_state(got, jax_recs[1])


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_each_rank_holds_its_shards(ranks, mode):
    """A rank's moments (and under FSDP its params) are ⌈n/W⌉ elements a
    leaf (a stacked leaf: a layer), padding included, before and after a
    step; the 0-d logit_scale stays whole. Under FSDP no tensor autograd
    keeps outside the recomputed regions has a block weight's shape: the
    gathered block weights live only inside a block."""
    results, _ = ranks
    for r in results:
        for key in ("sizes", "sizes_after"):
            sizes = r[f"{mode}:contrastive"][key]
            for i, (shape, rows, replicated) in enumerate(sizes["specs"]):
                n = int(np.prod(shape))
                want = n if replicated else rows * -(-(n // rows) // WORLD)
                assert sizes["mu"][i] == sizes["nu"][i] == want, (shape, sizes["mu"][i])
                assert sizes["params"][i] == (want if mode == "fsdp" else n)
            assert sum(sizes["mu"]) < 0.51 * sum(int(np.prod(s)) for s, _, _ in sizes["specs"])
    if mode == "fsdp":
        from clip_event_tpu_torch.engine.optim import tree_leaves

        params, _ = W.init_params("contrastive")
        towers = (params["visual"].pop("transformer"), params.pop("text_transformer"))
        blocks = {tuple(v.shape[1:]) for tower in towers for v in tree_leaves(tower)}
        # a block weight's shape that no other leaf has
        blocks -= {tuple(v.shape) for v in tree_leaves(params)}
        saved = results[0]["fsdp:contrastive"]["saved_shapes"]
        assert blocks and saved and not (blocks & saved), blocks & saved


def _leaves(obj, prefix=""):
    """A checkpoint's leaves by dotted key."""
    if not isinstance(obj, (dict, list)):
        return {prefix: obj}
    out = {}
    for k, v in (obj.items() if isinstance(obj, dict) else enumerate(obj)):
        out.update(_leaves(v, f"{prefix}.{k}"))
    return out


def _file_layout(obj):
    """A checkpoint's keys, and its tensors' shapes and dtypes."""
    return {k: (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else type(v)
            for k, v in _leaves(obj).items()}


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_sharded_checkpoint_is_the_unsharded_file(ranks, mode):
    """The file a 2-rank sharded run wrote is laid out as the plain 2-rank
    run's (the same keys, shapes and dtypes; FSDP's, after the same step,
    within 1e-6 of each tree's largest value) and holds the full state the
    ranks gathered: the port's restore at a world of one and JAX's
    `import_initial_checkpoint` read equal tensors."""
    from clip_event_tpu.engine.checkpoint import import_initial_checkpoint
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint

    results, _ = ranks
    got = results[0][f"{mode}:contrastive"]
    sharded, plain = (torch.load(results[0][c]["ckpt"], map_location="cpu", weights_only=False)
                      for c in (f"{mode}:contrastive", "plain:contrastive"))
    assert _file_layout(sharded) == _file_layout(plain)
    if mode == "fsdp":
        for tree in ("state_dict", "optimizer"):
            a, b = (_leaves(f[tree]) for f in (sharded, plain))
            top = max(float(v.float().abs().max()) for v in b.values())
            assert all(float((a[k].float() - b[k].float()).abs().max()) <= 1e-6 * top for k in b)
    params, opt_state, meta, tcfg = restore_checkpoint(got["ckpt"])
    assert meta["step"] == got["count"] == int(opt_state["count"])
    sd = state_dict_from_params(params, tcfg)
    assert sd.keys() == got["params"].keys()
    assert all(np.array_equal(sd[k], got["params"][k]) for k in sd)
    for tree in ("mu", "nu"):
        moment = state_dict_from_params(opt_state[tree], tcfg)
        assert all(np.array_equal(moment[k], got[tree][k]) for k in moment)
    jparams, jcfg = import_initial_checkpoint(got["ckpt"])
    jsd = state_dict_from_params(jax.tree.map(np.asarray, jparams), tcfg)
    assert all(np.array_equal(jsd[k], got["params"][k]) for k in jsd)


def test_cross_topology_resume(ranks):
    """A ZeRO-1 state saved after two 2-rank steps, restored at a world of
    one and stepped on the third global batch, against JAX's three steps."""
    from clip_event_tpu_torch.engine import optim as TO
    from clip_event_tpu_torch.engine import train_step as TT
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint

    results, _ = ranks
    got = results[0]["zero:contrastive"]
    jax_recs = _jax_adam("contrastive", steps=3)
    _close_metrics(got["metrics2"], jax_recs[1]["metrics"])
    _close_state(got, jax_recs[1])
    params, opt_state, meta, tcfg = restore_checkpoint(got["ckpt"])
    opt = W.adam()
    state = TT.create_train_state(params, opt)._replace(opt_state=opt_state, step=meta["step"])
    step = TT.make_train_step(tcfg, opt, compute_dtype=torch.float32, remat=True)
    batch = W.make_batches("contrastive", WORLD, B_LOCAL, W.ADAM_SEEDS[2])[0]
    state, m = step(state, W._t(batch))
    _close_metrics({k: float(v) for k, v in m.items()}, jax_recs[2]["metrics"])
    rec = {"params": state_dict_from_params(state.params, tcfg)}
    for tree in ("mu", "nu"):
        rec[tree] = state_dict_from_params(state.opt_state[tree], tcfg)
    assert state.step == 3 and int(state.opt_state["count"]) == 3
    _close_state(rec, jax_recs[2])
    assert TO.tree_leaves(state.params)[0].shape == TO.tree_leaves(params)[0].shape


def test_world_of_one_file_resumes_under_fsdp(ranks):
    """A world-of-one step's file, restored by both ranks, sharded (FSDP)
    and stepped at 2 ranks, against JAX's two steps."""
    got = _ranks_agree(ranks[0], "fsdp:from_one")
    jax_recs = _jax_adam("contrastive", steps=2)
    _close_metrics(got["metrics"], jax_recs[1]["metrics"])
    assert got["count"] == 2
    _close_state(got, jax_recs[1])
