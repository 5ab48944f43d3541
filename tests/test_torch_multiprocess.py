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
    and text once, features within 1e-6 of a one-process run.

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
    cases = ("comm",) + STEP_CASES + ("accum_dedupe", "evals", "embed")
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
