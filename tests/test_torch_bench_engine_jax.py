"""The timed callables of the port's component bench sections on the
branches and the engine (`alignment`, `multiattention`, `dedupe`, `accum`,
`ckpt`, `moments`) against the JAX expressions that the JAX tool's sections
time (root `tools/bench_components.py`), on the same weights (JAX's init,
carried over by `params_from_jax`) and the same inputs, in fp32 on the CPU.
The JAX side runs its plain attention and the plain OT loop
(`use_pallas_ot=False`, as its `alignment` section does); the port's
kernel variants run their plain versions here.

Bars: the train steps' loss terms and grad_norm within 1e-5 (each of two
steps a call), the updated params within 1e-5; a deduped layout against
the plain layout of the same rows within 1e-5 (equal up to float reduction
order, `data/dedupe.py`); the checkpoint files bit for bit. Model: the tiny
`MODEL` of tests/test_torch_bench.py with one layer a tower (`--layers 1`,
as tests/test_torch_bench_sections.py runs the sections). Kept apart from
tests/test_torch_bench_sections_jax.py so that the two files' JAX compiles
run on two workers."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint, wait_for_saves  # noqa: E402
from clip_event_tpu_torch.engine.optim import tree_leaves  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.parallel.sharding import tree_bytes  # noqa: E402
from clip_event_tpu_torch.tools import bench_components as BC  # noqa: E402

from tests.test_torch_bench import MODEL  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

KW = dict(json.loads(MODEL), vision_layers=1, transformer_layers=1)
JCFG, TCFG = J.CLIPConfig(**KW), T.CLIPConfig(**KW)
F32 = torch.float32
CPU = torch.device("cpu")
B, STEPS = 2, 2
TERMS = ("loss", "grad_norm", "loss_i", "loss_t")


@pytest.fixture(scope="module")
def jparams():
    init = jax.jit(lambda key: J.init_params(key, JCFG))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jparams, TCFG, "cpu")


def _np(t):
    return t.numpy()


def _jadam(moment_dtype=None):
    return JO.build_optimizer("adam", JO.build_schedule("none", 1e-6, 30), moment_dtype=moment_dtype)


def _jax_steps(jparams, batch, moment_dtype=None, **kw):
    """STEPS steps of JAX's `make_multi_step` on one batch (the JAX
    sections' step: "ce", overbatch, full remat, Adam at lr 1e-6), fp32;
    (state, metrics)."""
    jopt = _jadam(moment_dtype)
    _, run_k = JT.make_multi_step(JCFG, jopt, STEPS, loss_type="ce", overbatch=True,
                                  compute_dtype=jnp.float32, remat=True, donate=False, **kw)
    state = JT.create_train_state(jax.tree.map(jnp.asarray, jparams), jopt)
    return run_k(state, {k: jnp.asarray(_np(v)) for k, v in batch.items()})


def _same(ours, ref, keys=TERMS, what=""):
    for k in keys:
        np.testing.assert_allclose(_np(ours[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what} {k}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _params_close(ours, ref):
    a, b = _flat(ours), _flat(jax.tree.map(np.asarray, ref))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].detach().numpy(), b[k], atol=1e-5, rtol=0, err_msg=k)


# ------------------------------------------------------------ branches


def test_alignment_call_matches_jax(jparams, tparams):
    """The alignment section's step (11 crops and 16 entities an image, 4
    chunks requested, the plain OT loop) against JAX's with
    `use_pallas_ot=False`, as the JAX section runs it."""
    data = BC.alignment_batch(TCFG, B, BC.ALIGN_OBJECTS, CPU)
    assert data["object_image"].shape == (B, BC.ALIGN_OBJECTS, 32, 32, 3)
    assert data["entity_text"].shape == (B, BC.ALIGN_ENTITIES, 16)
    assert (data["entity_text"][..., -1] == TCFG.vocab_size - 1).all()
    assert data["entity_mask"].dtype == data["object_mask"].dtype == torch.bool
    _, jm = _jax_steps(jparams, data, alignment=True, use_pallas_ot=False,
                       alignment_chunks=BC.ALIGN_CHUNKS)
    m = BC.alignment_call(TCFG, tparams, data, STEPS, BC.ALIGN_CHUNKS, F32)()
    _same(m, jm, TERMS + ("loss_ot",), "alignment")
    assert (m["loss_ot"] > 0).all()


@pytest.mark.parametrize("mode", BC.MULTIATTENTION_MODES)
def test_multiattention_call_matches_jax(jparams, tparams, mode):
    data = BC.multiattention_batch(TCFG, B, BC.BBOXES, CPU)
    box = data["bbox"]
    assert (box[..., 0] <= box[..., 2]).all() and (box[..., 1] <= box[..., 3]).all()
    assert data["bbox_mask"].dtype == torch.int32 and data["bbox_desc_text"].shape == (B, BC.BBOXES, 16)
    _, jm = _jax_steps(jparams, data, multiattention=mode)
    m = BC.multiattention_call(TCFG, tparams, data, STEPS, mode, F32)()
    _same(m, jm, TERMS + ("loss_bbox", "loss_arg"), mode)


# -------------------------------------------------------------- dedupe


def _plain(batch):
    """The same rows in the plain layout: every deduped channel gathered
    back (`unique[inverse]`)."""
    out = {k: v for k, v in batch.items() if not k.endswith(("_unique", "_inverse"))}
    R = batch["bbox"].shape[1] if "bbox" in batch else None
    for prefix, key in (("text", "text"), ("bbox_desc", "bbox_desc_text"), ("bbox_label", "bbox_label_text")):
        if f"{prefix}_unique" in batch:
            rows = batch[f"{prefix}_unique"][batch[f"{prefix}_inverse"].long()]
            out[key] = rows if prefix == "text" else rows.reshape(B, R, -1)
    return out


def test_texts_from_vocab_is_the_jax_sections_draw():
    rows = BC.texts_from_vocab(TCFG, 40, 5, seed=3)
    r = np.random.default_rng(3)
    vocab = r.integers(1, 127, size=(5, 16)).astype(np.int32)
    vocab[:, -1] = 127
    assert np.array_equal(rows, vocab[r.integers(0, 5, size=40)])
    assert len(np.unique(rows, axis=0)) <= 5


def test_dedupe_steps_match_jax_and_the_plain_layout(jparams, tparams):
    """The deduped text layout (U = 96) against JAX's deduped step and
    against the port's plain layout of the same rows; the plain layout's
    step against JAX's."""
    (plain_name, plain), (name, ded) = BC.dedupe_layouts(TCFG, B, (96,), CPU)
    assert plain_name == "step plain" and name == "step deduped (U=96 of 6)"
    assert "text" not in ded and ded["text_unique"].shape == (96, 16) and ded["text_inverse"].shape == (6,)
    _, jm = _jax_steps(jparams, ded)
    m = BC.step_call(TCFG, tparams, ded, "kernel", STEPS, F32)()
    _same(m, jm, what=name)
    _same(m, BC.step_call(TCFG, tparams, _plain(ded), "kernel", STEPS, F32)(), what=f"{name} / plain")
    _, jm = _jax_steps(jparams, plain)
    _same(BC.step_call(TCFG, tparams, plain, "kernel", STEPS, F32)(), jm, what=plain_name)


@pytest.mark.parametrize("mode", BC.MULTIATTENTION_MODES)
def test_dedupe_multiattention_layouts_match(jparams, tparams, mode):
    """The sr-deduped and all-deduped layouts against the plain layout of
    the same rows, and ("desc_type", which reads both role channels)
    against JAX's step on the same deduped batch."""
    layouts = dict(BC.dedupe_multiattention_layouts(TCFG, B, BC.BBOXES, CPU))
    assert list(layouts) == ["plain", "sr-deduped (U=64)", "all-deduped"]
    plain = BC.multiattention_call(TCFG, tparams, layouts["plain"], STEPS, mode, F32)()
    keys = TERMS + ("loss_bbox", "loss_arg")
    for name in ("sr-deduped (U=64)", "all-deduped"):
        batch = layouts[name]
        assert batch["bbox_desc_unique"].shape == (64, 16) and "bbox_desc_text" not in batch
        assert ("text" in batch) == (name != "all-deduped")
        for k, v in _plain(batch).items():
            assert torch.equal(v, layouts["plain"][k]), (name, k)
        m = BC.multiattention_call(TCFG, tparams, batch, STEPS, mode, F32)()
        _same(m, plain, keys, f"{name} / plain")
        if mode == "desc_type":
            _same(m, _jax_steps(jparams, batch, multiattention=mode)[1], keys, name)


# ------------------------------------------------------------- engine


def test_accum_call_matches_jax_make_accum_step(jparams, tparams):
    """One K = 2 optimizer step on the step section's batch stacked twice:
    loss, grad_norm and the updated params against JAX's
    `make_accum_step`."""
    data = BC.step_batch(TCFG, B, CPU)
    call = BC.accum_call(TCFG, tparams, data, 2, F32)
    m = call()
    jopt = _jadam()
    step = JT.make_accum_step(JCFG, jopt, 2, loss_type="ce", overbatch=True, compute_dtype=jnp.float32,
                              remat=True, donate=False)
    stacked = {k: jnp.stack([jnp.asarray(_np(v))] * 2) for k, v in data.items()}
    js, jm = jax.jit(step)(JT.create_train_state(jax.tree.map(jnp.asarray, jparams), jopt), stacked)
    _same(m, jm)
    _params_close(call.state[0].params, js.params)
    assert int(call.state[0].opt_state["count"]) == 1
    assert (BC.accum_calls(2, 10), BC.accum_calls(4, 10), BC.accum_calls(4, 1)) == (15, 7, 4)


def test_bf16_moments_match_optax(jparams, tparams):
    """Adam with bf16 first moments (`moment_dtype="bfloat16"`): the params
    after two steps against JAX's optax, and the stored moments' dtypes."""
    data = BC.step_batch(TCFG, B, CPU)
    call = BC.step_call(TCFG, tparams, data, "kernel", STEPS, F32, moment_dtype="bfloat16")
    m = call()
    js, jm = _jax_steps(jparams, data, moment_dtype="bfloat16")
    _same(m, jm)
    _params_close(call.state[0].params, js.params)
    adam = js.opt_state[1]
    assert {leaf.dtype for leaf in jax.tree.leaves(adam.mu)} == {jnp.dtype(jnp.bfloat16)}
    assert {t.dtype for t in tree_leaves(call.state[0].opt_state["mu"])} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(call.state[0].opt_state["nu"])} == {torch.float32}


def test_ckpt_state_bytes_and_files(jparams, tparams, tmp_path):
    """The ckpt section's state size against JAX's `nbytes` sum of the same
    state, and its sync and async saves restored bit for bit."""
    data = BC.step_batch(TCFG, B, CPU)
    call = BC.step_call(TCFG, tparams, data, "kernel", 1, F32)
    state = call.state[0]
    jopt = _jadam()
    jstate = JT.create_train_state(jax.tree.map(jnp.asarray, jparams), jopt)
    jbytes = sum(leaf.nbytes for leaf in jax.tree.leaves((jstate.params, jstate.opt_state)))
    # optax's chain keeps a second int32 step count (the schedule's,
    # ScaleByScheduleState) beside Adam's; the port's Optimizer keeps one
    assert tree_bytes(state.params, state.opt_state) == jbytes - 4
    call()  # a step: the saved state is not the init
    paths = {}
    for mode in ("sync", "async"):
        paths[mode] = BC.save_call(str(tmp_path), mode, state, TCFG, mode == "async")()
    wait_for_saves()
    restored = {mode: restore_checkpoint(path) for mode, path in paths.items()}
    for params, opt_state, meta, _ in restored.values():
        assert meta["epoch"] == 0
        for ours, saved in ((state.params, params), (state.opt_state, opt_state)):
            a, b = _flat(ours), _flat(saved)
            assert a.keys() == b.keys()
            for k, x in a.items():
                assert x.dtype == b[k].dtype and torch.equal(x.detach(), b[k]), k
