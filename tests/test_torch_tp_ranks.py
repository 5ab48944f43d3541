"""Tensor, sequence and multi-slice data parallelism of the port across
processes, on the CPU over gloo: one module-scoped spawn of 4 ranks
(tests/torch_multiprocess_worker.py `run_tp`), each case on its own mesh
of the 4 ranks, against JAX's single-process step on the global batch
from the port's init (carried over by the state dict):

  * (dp=2, tp=2) contrastive, under full remat; the same with sequence
    parallelism (no remat; the LayerNorm kernels' plain versions on the
    local rows); under remat "attn"; two accumulated microbatches (the
    description texts deduped into the data ranks' blocks); a 2-step
    `make_multi_step` dispatch (sp, "attn": `pretrain_vitl14_tp2.json`'s
    settings); (dcn=2, dp=1, tp=2); (dcn=2, dp=2, tp=1). SGD at lr 0.1 with the clip at 1.0 (the norm is
    over 1, so a wrong grad_norm moves every param): every loss term and
    every updated param within 1e-5, grad_norm within 1e-5 relative; every
    rank's gathered params and metrics bit for bit the same, and the ranks
    of a tp group bit for bit equal in every whole leaf;
  * the M2E2 eval under tp = 2 (the model split over each tp group, the
    rows over the data ranks) against one process;
  * the checkpoint a tp run writes (Adam): the unsharded file's layout,
    its tensors the gathered state's, read by JAX's
    `import_initial_checkpoint`; a world-of-one file resumed at tp = 2 and
    stepped, against JAX's two steps;
  * pipeline parallelism and ZeRO-1 / FSDP over a model axis, each on 4
    global rows (the 2 data ranks' batches of the contrastive cases, so
    JAX's same runs): (dp=2, pp=2) contrastive under full remat and under
    "attn"; (dp=1, pp=4), where the 4-layer text stack runs 4 stages and
    the 2-layer vision stack, which does not divide, runs whole on every
    rank; (dp=2, pp=2) + zero or fsdp, (dp=2, tp=2) + fsdp and (dcn=2,
    dp=2) + zero or fsdp, whose state stays within the slice (Adam); the
    train loop at (dp=2, pp=2) against a world of one; the checkpoint a
    pp run writes, and a world-of-one file resumed at pp = 2. Every rank's
    gathered params bit for bit the same, and the ranks of a pp group
    equal in every leaf outside the stages.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models.convert import params_from_state_dict  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import state_dict_from_params  # noqa: E402
from tests import torch_multiprocess_worker as W  # noqa: E402
from tests.fixtures import make_m2e2_fixture, make_voa_fixture  # noqa: E402

WORLD, B_LOCAL = 4, 2
TOL = 1e-5
STEP_CASES = ("contrastive", "sp", "attn", "dcn_tp", "dcn_dp")
COMPOSED_STEPS = ("pp", "pp_attn", "pp4", "pp_zero", "fsdp", "dcn_zero", "pp_fsdp", "dcn_fsdp")
CASES = tuple(f"tp/{c}" for c in W.TP_MESHES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four ranks for every case; its wall time."""
    out = tmp_path_factory.mktemp("tp_ranks")
    os.makedirs(out / "m2e2")
    fixtures = {"m2e2": make_m2e2_fixture(str(out / "m2e2"), num_images=7),
                "voa": make_voa_fixture(str(out / "voa"), num_docs=6, images_per_doc=2)}
    start = time.perf_counter()
    mp.spawn(W.main, args=(WORLD, str(out), CASES, B_LOCAL, fixtures, ()), nprocs=WORLD, join=True)
    seconds = time.perf_counter() - start
    results = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results, seconds


_JAX = {}


def _jax_run(case):
    """JAX's steps of a tp case on its global batches, from the port's init:
    a record (metrics, params' state dict) after each step. The cases that
    share their optimizer and global batches share one run: SGD on the 2
    data ranks' batches of `TP_SEEDS` (its first step is the one-step
    cases'), SGD on the 4 data ranks' batch, the accumulated step, Adam on
    the 2 data ranks' batches (the checkpoint's step, then the resume's)."""
    tp, dcn, _, pp = W.TP_MESHES[case]
    # the composed cases' 4 global rows are the 2 data ranks' batches
    world = 2 if case in W.COMPOSED else WORLD // (tp * pp)
    adam = case in W.ADAM_CASES
    key = ("accum" if case == "accum" else "adam" if adam else "sgd", world)
    if key in _JAX:
        return _JAX[key]
    tcfg, jcfg = T.CLIPConfig(**W.TP_VIT), J.CLIPConfig(**W.TP_VIT)
    params, _ = W.init_params(f"tp/{case}")
    np_params = params_from_state_dict(state_dict_from_params(params, tcfg), jcfg)[0]
    if adam:
        opt = JO.build_optimizer("adam", JO.build_schedule("none", W.ADAM_LR, 1), grad_clip_norm=1.0)
    else:
        opt = JO.build_optimizer("sgd", JO.build_schedule("none", W.LR, 1), grad_clip_norm=1.0)
    kw = dict(loss_type="ce", donate=False, compute_dtype=jnp.float32, remat=False)
    if case == "accum":
        micro = [W.make_batches("accum_dedupe", world, B_LOCAL, 20 + k)[0] for k in range(2)]
        batches = [{k: np.stack([m[k] for m in micro]) for k in micro[0]}]
        step = JT.make_accum_step(jcfg, opt, 2, **kw)
    else:
        seeds = W.TP_SEEDS if world == 2 else W.TP_SEEDS[:1]
        batches = [W.make_batches("contrastive", world, B_LOCAL, s)[0] for s in seeds]
        step = JT.make_train_step(jcfg, opt, **kw)
    state = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), opt)
    records = []
    for batch in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        records.append({"metrics": {k: float(v) for k, v in metrics.items()},
                        "params": state_dict_from_params(jax.tree.map(np.asarray, state.params), tcfg)})
    _JAX[key] = records
    return records


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "grad_norm":
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
    assert got["finite"] == 1.0


def _close_params(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)


def _ranks_agree(results, case):
    """Every rank's metrics and gathered params bit for bit rank 0's; the
    ranks of a tp or pp group equal in every whole leaf."""
    r0 = results[0][f"tp/{case}"]
    tp, _, _, pp = W.TP_MESHES[case]
    for rank, r in enumerate(results):
        got = r[f"tp/{case}"]
        assert got["metrics"] == r0["metrics"]
        assert all(np.array_equal(got["params"][k], r0["params"][k]) for k in r0["params"])
        lead = results[rank - rank % (tp * pp)][f"tp/{case}"]
        assert len(got["whole"]) == len(lead["whole"])
        assert all(np.array_equal(a, b) for a, b in zip(got["whole"], lead["whole"]))
    assert [r[f"tp/{case}"]["mesh"][2] for r in results] == [i % tp for i in range(WORLD)]
    return r0


def test_spawn_layout_and_time(ranks):
    """The meshes' coordinates (rank = (dcn_idx·DP + dp_idx)·TP + tp_idx) and
    the data ranks; the spawn's wall time is logged for the tier-1 budget."""
    results, seconds = ranks
    coords = {c: [r[f"tp/{c}"]["mesh"] for r in results] for c in ("contrastive", "dcn_tp", "dcn_dp")}
    assert coords["contrastive"] == [(0, 0, 0, 0, 2), (0, 0, 1, 0, 2), (0, 1, 0, 1, 2), (0, 1, 1, 1, 2)]
    assert coords["dcn_tp"] == [(0, 0, 0, 0, 2), (0, 0, 1, 0, 2), (1, 0, 0, 1, 2), (1, 0, 1, 1, 2)]
    assert coords["dcn_dp"] == [(0, 0, 0, 0, 4), (0, 1, 0, 1, 4), (1, 0, 0, 2, 4), (1, 1, 0, 3, 4)]
    # 6 split leaves a stack, two stacks, and the token embedding
    assert results[0]["tp/contrastive"]["split"] == 13 and results[0]["tp/dcn_dp"]["split"] == 0
    print(f"4-rank tp spawn: {seconds:.1f} s")


@pytest.mark.parametrize("case", STEP_CASES)
def test_tp_step_matches_jax_on_the_global_batch(ranks, case):
    got = _ranks_agree(ranks[0], case)
    want = _jax_run(case)[0]
    _close_metrics(got["metrics"], want["metrics"])
    _close_params(got["params"], want["params"])
    params, tcfg = W.init_params(f"tp/{case}")
    init = state_dict_from_params(params, tcfg)
    # the clipped step moved the params: a gradient off by a factor shows
    assert got["metrics"]["grad_norm"] > 1.0
    assert max(np.abs(got["params"][k] - init[k]).max() for k in init) > 1e-3


@pytest.mark.parametrize("case", ["contrastive", "sp"])
def test_tp_grad_norm_counts_each_leaf_once(ranks, case):
    """The pre-clip norm: each split leaf's squares summed over its tp
    slices, a whole leaf counted once: JAX's unsharded norm within 1e-5
    relative, and far from the norms a leaf counted tp times, or a slice
    alone, would give."""
    got = ranks[0][0][f"tp/{case}"]["metrics"]["grad_norm"]
    want = _jax_run(case)[0]["metrics"]["grad_norm"]
    np.testing.assert_allclose(got, want, rtol=TOL)
    for wrong in (want * np.sqrt(2), want / np.sqrt(2)):
        assert abs(got - wrong) > 1e-2 * want


def test_sp_keeps_the_local_rows_of_each_block_input(ranks):
    """Under remat "attn" a block keeps its input for the backward: the
    whole stream under tp alone, the rank's ⌈S/tp⌉ rows under sequence
    parallelism (ln_1 runs on them, and the saved region gathers its
    output again in the backward); the rest, the core's output and lse, is
    alike. So sp keeps L·B·(S − ⌈S/tp⌉)·W·4 bytes fewer (the "attn" case
    against the sp + "attn" dispatch case, both tp = 2)."""
    results, _ = ranks
    tp_bytes, sp_bytes = (results[0][f"tp/{c}"]["saved"] for c in ("attn", "multi_step"))
    layers, width, seq = W.TP_VIT["vision_layers"], W.TP_VIT["vision_width"], W.SAVED_SEQ
    assert tp_bytes - sp_bytes == layers * 2 * (seq - -(-seq // 2)) * width * 4
    print(f"saved activations, vision stack, 2 x {seq} x {width}: tp {tp_bytes} B, sp {sp_bytes} B")


def test_tp_accumulated_step_matches_jax(ranks):
    got = _ranks_agree(ranks[0], "accum")
    want = _jax_run("accum")[0]
    _close_metrics(got["metrics"], want["metrics"])
    _close_params(got["params"], want["params"])


def test_tp_multi_step_dispatch_matches_jax(ranks):
    """Two steps in one dispatch under sp and remat "attn" against JAX's
    two steps."""
    got = _ranks_agree(ranks[0], "multi_step")
    want = _jax_run("multi_step")
    assert len(want) == 2
    for j, rec in enumerate(want):
        _close_metrics({k: v[j] for k, v in got["metrics"].items()}, rec["metrics"])
    _close_params(got["params"], want[-1]["params"])


def test_pp_multi_step_dispatch_matches_jax(ranks):
    """Two steps in one `make_multi_step` dispatch at (dp 2, pp 2) (on the
    CPU, two eager steps of the pipelined step) against JAX's two steps."""
    got = _ranks_agree(ranks[0], "pp_multi_step")
    want = _jax_run("pp_multi_step")
    assert len(want) == 2
    for j, rec in enumerate(want):
        _close_metrics({k: v[j] for k, v in got["metrics"].items()}, rec["metrics"])
    _close_params(got["params"], want[-1]["params"])


def test_tp_m2e2_eval_equals_one_process(ranks):
    """The model split over each tp group and the images over the two data
    ranks: the metrics of one process on whole weights, on every rank."""
    results, _ = ranks
    sharded, single = results[0]["tp/evals"]["sharded"], results[0]["tp/evals"]["single"]
    assert sharded == single and sharded["num_images"] == 7
    assert all(r["tp/evals"]["sharded"] == sharded for r in results)


def test_tp_checkpoint_is_the_unsharded_file(ranks, tmp_path):
    """The file a tp = 2 run writes is the unsharded one: laid out as a
    one-process run's file, its params and moments the state the ranks
    gathered, bit for bit, within 1e-5 of JAX's Adam step, and read by
    JAX's `import_initial_checkpoint` with equal tensors."""
    from clip_event_tpu.engine.checkpoint import import_initial_checkpoint
    from clip_event_tpu_torch.engine import train_step as TT
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint

    results, _ = ranks
    got = _ranks_agree(results, "ckpt")
    _close_metrics(got["metrics"], _jax_run("ckpt")[0]["metrics"])
    _close_params(got["params"], _jax_run("ckpt")[0]["params"])
    params, tcfg = W.init_params("tp/ckpt")
    opt = W.adam()
    one, _ = TT.make_train_step(tcfg, opt, compute_dtype=torch.float32)(
        TT.create_train_state(params, opt), W._t(W.make_batches("contrastive", 2, B_LOCAL, W.TP_SEEDS[0])[0]))
    plain = save_checkpoint(str(tmp_path), "one", 0, one.params, one.opt_state, tcfg, step=one.step)
    files = [torch.load(p, map_location="cpu", weights_only=False) for p in (got["ckpt"], plain)]
    layouts = [{k: tuple(v.shape) for k, v in f["state_dict"].items()} for f in files]
    assert layouts[0] == layouts[1]
    r_params, opt_state, meta, _ = restore_checkpoint(got["ckpt"])
    assert meta["step"] == got["count"] == int(opt_state["count"]) == 1
    sd = state_dict_from_params(r_params, tcfg)
    assert all(np.array_equal(sd[k], got["params"][k]) for k in sd)
    for tree in ("mu", "nu"):
        moment = state_dict_from_params(opt_state[tree], tcfg)
        assert all(np.array_equal(moment[k], got[tree][k]) for k in moment)
    jparams, _ = import_initial_checkpoint(got["ckpt"])
    jsd = state_dict_from_params(jax.tree.map(np.asarray, jparams), tcfg)
    assert all(np.array_equal(jsd[k], got["params"][k]) for k in jsd)


def test_pp_mesh_layout_and_stages(ranks):
    """rank = dp_idx·PP + pp_idx: the stage and the data rank of each rank
    (a pp group loads one data rank's rows); the stage leaves: the 12
    leaves of each stack that divides pp (both at pp = 2, the text stack
    alone at pp = 4)."""
    results, _ = ranks
    stages = {c: [(r[f"tp/{c}"]["stage"], r[f"tp/{c}"]["mesh"][3:]) for r in results] for c in ("pp", "pp4")}
    assert stages["pp"] == [((0, 2), (0, 2)), ((1, 2), (0, 2)), ((0, 2), (1, 2)), ((1, 2), (1, 2))]
    assert stages["pp4"] == [((p, 4), (0, 1)) for p in range(4)]
    assert results[0]["tp/pp"]["split"] == 24 and results[0]["tp/pp4"]["split"] == 12


@pytest.mark.parametrize("case", COMPOSED_STEPS)
def test_composed_step_matches_jax_on_the_global_batch(ranks, case):
    """A pipeline step, or ZeRO-1 / FSDP over a model axis, against JAX's
    single-process step on the global batch: every loss term and updated
    param within 1e-5, grad_norm within 1e-5 relative, every rank alike."""
    got = _ranks_agree(ranks[0], case)
    want = _jax_run(case)[0]
    _close_metrics(got["metrics"], want["metrics"])
    _close_params(got["params"], want["params"])
    params, tcfg = W.init_params(f"tp/{case}")
    init = state_dict_from_params(params, tcfg)
    assert got["metrics"]["grad_norm"] > 1.0
    assert max(np.abs(got["params"][k] - init[k]).max() for k in init) > (1e-6 if case in W.ADAM_CASES
                                                                          else 1e-3)


def test_composed_shards_are_the_data_ranks_chunks(ranks):
    """ZeRO-1 / FSDP over a model axis chunk the rank's own leaves over its
    data group: under (dp 2, pp 2) a stage leaf's moment shard is half its
    stage; under (dp 2, tp 2) + fsdp a split leaf's param shard is half its
    tp slice; under (dcn 2, dp 2) the chunks go over the slice's 2 data
    ranks, not the 4, and the two slices hold the same moments, bit for
    bit (the state never spans the dcn axis)."""
    results, _ = ranks
    for case, halves in (("pp_zero", "mu"), ("fsdp", "params"), ("dcn_zero", "mu"), ("pp_fsdp", "params"),
                         ("dcn_fsdp", "params")):
        sizes = results[0][f"tp/{case}"]["sizes"]
        for (shape, rows, replicated), n in zip(sizes["specs"], sizes[halves]):
            full = int(np.prod(shape))
            assert n == (full if replicated else rows * -(-(full // rows) // 2)), (case, shape, n)
    pp_specs = results[0]["tp/pp_zero"]["sizes"]["specs"]
    assert (1, 128, 384) in [s[0] for s in pp_specs]  # a vision stage: 1 of the 2 layers
    for r in range(2):
        a, b = (results[i]["tp/dcn_zero"]["moments"] for i in (r, r + 2))
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(results[0]["tp/dcn_zero"]["moments"],
                                                         results[1]["tp/dcn_zero"]["moments"]))


def test_pp_checkpoint_is_the_unsharded_file(ranks, tmp_path):
    """The file a (dp 2, pp 2) run writes is the unsharded one: laid out as
    a one-process run's file, its params and moments the state the ranks
    gathered (the stages laid back in layer order), bit for bit, within
    1e-5 of JAX's Adam step."""
    from clip_event_tpu_torch.engine import train_step as TT
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint

    results, _ = ranks
    got = _ranks_agree(results, "pp_ckpt")
    _close_metrics(got["metrics"], _jax_run("pp_ckpt")[0]["metrics"])
    _close_params(got["params"], _jax_run("pp_ckpt")[0]["params"])
    params, tcfg = W.init_params("tp/pp_ckpt")
    opt = W.adam()
    one, _ = TT.make_train_step(tcfg, opt, compute_dtype=torch.float32)(
        TT.create_train_state(params, opt), W._t(W.make_batches("contrastive", 2, B_LOCAL, W.TP_SEEDS[0])[0]))
    plain = save_checkpoint(str(tmp_path), "one", 0, one.params, one.opt_state, tcfg, step=one.step)
    files = [torch.load(p, map_location="cpu", weights_only=False) for p in (got["ckpt"], plain)]
    assert ({k: tuple(v.shape) for k, v in files[0]["state_dict"].items()}
            == {k: tuple(v.shape) for k, v in files[1]["state_dict"].items()})
    r_params, opt_state, meta, _ = restore_checkpoint(got["ckpt"])
    assert meta["step"] == got["count"] == int(opt_state["count"]) == 1
    sd = state_dict_from_params(r_params, tcfg)
    assert all(np.array_equal(sd[k], got["params"][k]) for k in sd)
    for tree in ("mu", "nu"):
        moment = state_dict_from_params(opt_state[tree], tcfg)
        assert all(np.array_equal(moment[k], got[tree][k]) for k in moment)


def test_world_of_one_file_resumes_at_pp2(ranks):
    """A world-of-one Adam step's file, restored by every rank, split into
    pp = 2 stages and stepped on the second global batch: JAX's two
    steps."""
    got = _ranks_agree(ranks[0], "pp_resume")
    want = _jax_run("pp_resume")
    assert got["count"] == 2
    _close_metrics(got["metrics"], want[1]["metrics"])
    _close_params(got["params"], want[1]["params"])


def test_pp_train_loop_matches_one_process(ranks):
    """`train.train` at (dp 2, pp 2), batch 2 a data rank, against the loop
    at a world of one at batch 4 (the same global batches, in another row
    order): the epoch's train loss within 1e-5, its validation (through
    the pipeline on each rank's stage, the set split over the 2 data
    ranks) equal, the final params within 1e-5 on every rank, and the
    epoch's checkpoint the unsharded file."""
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint
    from clip_event_tpu_torch.models.convert import state_dict_from_params

    results, _ = ranks
    got = results[0]["tp/pp_loop"]
    scalars = {name: {(r["tag"], r["step"]): r["value"] for r in got[name]["scalars"]} for name in ("pp", "one")}
    assert scalars["pp"].keys() == scalars["one"].keys() and ("val_i2t_top1", 0) in scalars["pp"]
    for key, value in scalars["one"].items():
        np.testing.assert_allclose(scalars["pp"][key], value, atol=TOL, rtol=0, err_msg=str(key))
    assert scalars["pp"][("val_i2t_top1", 0)] == scalars["one"][("val_i2t_top1", 0)]
    for r in results:
        assert all(np.array_equal(r["tp/pp_loop"]["pp"]["params"][k], got["pp"]["params"][k])
                   for k in got["pp"]["params"])
    _close_params(got["pp"]["params"], got["one"]["params"])
    params, _, meta, tcfg = restore_checkpoint(got["pp"]["ckpt"])
    sd = state_dict_from_params(params, tcfg)
    assert meta["epoch"] == 0 and all(np.array_equal(sd[k], got["pp"]["params"][k]) for k in sd)


def test_world_of_one_file_resumes_at_tp2(ranks):
    """A world-of-one Adam step's file, restored by every rank, split over
    tp = 2 and stepped on the second global batch: JAX's two steps."""
    got = _ranks_agree(ranks[0], "resume")
    want = _jax_run("resume")
    assert got["count"] == 2
    _close_metrics(got["metrics"], want[1]["metrics"])
    _close_params(got["params"], want[1]["params"])
