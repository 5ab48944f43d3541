"""The port's training step against the JAX package, on the CPU in fp32:
the contrastive losses, the five LR schedules, Adam and SGD (clip, weight
decay, bf16 first moment), three full train steps with and without remat,
the gradient-accumulation step, the dedupe path and the non-finite freeze.

Both sides start from the JAX init carried over by `params_from_jax` and
take the same numpy batches. Model: ViT towers of 2 layers, vision width
128 (2 heads), patch 16, image 32; text width 64, 2 heads, 77 tokens,
vocab 512. The JAX side runs its einsum attention (the plain reference of
its Pallas kernel; the two agree in fp32, tests/test_attention_pallas.py).

Tolerances: losses and params atol 1e-5, grad_norm rtol 1e-4 (fp32 on both
sides, only reduction orders differ); schedules rtol 1e-6 plus atol 1e-8
(both fp32: a few ulps of cos near its zero); optimizer params atol 1e-6,
bf16 moments rtol 1e-2 (one bf16 rounding); dedupe gradients atol 1e-5
(a gather's scatter-add sums in another order than the matmuls).

Params after full steps: with SGD (an update linear in the gradient)
every param is held at atol 1e-5. With Adam, whose update divides each
gradient element by its own running scale, an element whose gradient is
at the level of rounding noise (the k part of each qkv bias has a zero
gradient in exact arithmetic; a few others come close) takes a step of up
to ~lr on either side whatever the noise, so there the params are held to
Adam's bound of 2·lr per step; the first step's gradients are held
directly instead, each tensor within 1e-5 of its largest element, and the
Adam update itself is held to optax's on equal gradients (test above)."""

import numpy as np
import optax
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.data.labels import build_label_layout as jax_layout  # noqa: E402
from clip_event_tpu.engine import losses as JLS  # noqa: E402
from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.data.dedupe import dedupe_rows  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.engine import losses as TLS  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=512,
    transformer_width=64, transformer_heads=2, transformer_layers=2,
)
JCFG = J.CLIPConfig(**CFG_KW)
TCFG = T.CLIPConfig(**CFG_KW)
B, NPOS, NNEG = 4, 1, 2
D = NPOS + NNEG
LR = 1e-4


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), JCFG))


def _tokens(rng, n):
    V = CFG_KW["vocab_size"]
    out = np.zeros((n, 77), np.int32)
    for i in range(n):
        eot = int(rng.integers(2, 40))
        out[i, 0] = V - 2
        out[i, 1:eot] = rng.integers(1, V - 2, eot - 1)
        out[i, eot] = V - 1
    return out


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    layout = build_label_layout(b, NPOS, NNEG)
    return {
        "image": rng.integers(0, 256, size=(b, 32, 32, 3), dtype=np.uint8),
        "text": _tokens(rng, b * D),
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
    }


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().float() if isinstance(v, torch.Tensor) else v,
                                         np.float32)
    return out


def _close_trees(ours, ref, atol, rtol=0.0):
    a, b = _flat(ours), _flat(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol, err_msg=k)


# ------------------------------------------------------------------ losses


def test_label_layout_copy_matches():
    for args in [(4, 1, 2, "ce", True), (3, 1, 2, "ce", False), (3, 2, 2, "bce", False),
                 (2, 1, 3, "kl", True)]:
        for a, b in zip(build_label_layout(*args), jax_layout(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("loss_type,overbatch", [("ce", True), ("ce", False), ("bce", False),
                                                 ("kl", True)])
def test_contrastive_loss_matches(loss_type, overbatch):
    rng = np.random.default_rng(2)
    layout = build_label_layout(B, NPOS if loss_type != "bce" else 1, NNEG, loss_type, overbatch)
    lpi = rng.normal(size=(B, B * D if overbatch else D)).astype(np.float32) * 5
    lpt = rng.normal(size=(B * D, B)).astype(np.float32) * 5
    args = (layout.labels_per_image, layout.labels_per_text, layout.index_pos)

    def jfn(a, b):
        out = JLS.contrastive_loss(a, b, *map(jnp.asarray, args), loss_type=loss_type)
        return out["loss_i"] + 2.0 * out["loss_t"], out

    (jtot, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(lpi), jnp.asarray(lpt))
    ta = torch.from_numpy(lpi).requires_grad_(True)
    tb = torch.from_numpy(lpt).requires_grad_(True)
    tout = TLS.contrastive_loss(ta, tb, *map(torch.from_numpy, args), loss_type=loss_type)
    tgrads = torch.autograd.grad(tout["loss_i"] + 2.0 * tout["loss_t"], (ta, tb))
    for k in ("loss_i", "loss_t"):
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), atol=1e-6, rtol=1e-6)
    for g, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    with pytest.raises(ValueError, match="invalid contrastive loss"):
        TLS.contrastive_loss(ta, tb, *map(torch.from_numpy, args), loss_type="hinge")


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("name", ["none", "multisteplr", "cosineannealinglr", "warmup",
                                  "warmupmultisteplr"])
def test_schedules_match(name):
    kw = dict(begin_epoch=1, steps_per_epoch=3, lr_steps=[2, 5], lr_gamma=0.5, warmup_epochs=3)
    js = JO.build_schedule(name, 0.1, 10, **kw)
    ts = TO.build_schedule(name, 0.1, 10, **kw)
    for step in range(40):
        ours = ts(step)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(js(step)), rtol=1e-6, atol=1e-8,
                                   err_msg=str(step))
    # a step count on the device (the optimizer's) gives the same value
    np.testing.assert_allclose(float(ts(torch.tensor(7, dtype=torch.int32))), float(js(7)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="invalid lr scheduler"):
        TO.build_schedule("linear", 0.1, 10)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_steps_match(name, moment_dtype):
    """3 updates with clip at 1.0 (steps 0 and 2 exceed it), L2 weight
    decay 0.01 and the warmup schedule: params after each step, moments
    after the last."""
    rng = np.random.default_rng(5)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 4)}}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))

    params = draw(1.0)
    sched = dict(begin_epoch=0, steps_per_epoch=1, warmup_epochs=2)
    jopt = JO.build_optimizer(name, JO.build_schedule("warmup", 0.05, 6, **sched),
                              weight_decay=0.01, grad_clip_norm=1.0, moment_dtype=moment_dtype)
    topt = TO.build_optimizer(name, TO.build_schedule("warmup", 0.05, 6, **sched),
                              weight_decay=0.01, grad_clip_norm=1.0, moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for scale in (3.0, 0.05, 2.0):
        grads = draw(scale)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        new, tstate = topt.update(jax.tree.map(torch.from_numpy, grads), tstate, tp)
        tp = TO.tree_unflatten(tp, new)
        _close_trees(tp, jp, atol=1e-6)
    assert int(tstate["count"]) == 3
    mu_key = "mu" if name == "adam" else "trace"
    jmu = [s for s in jax.tree.leaves(jstate, is_leaf=lambda x: hasattr(x, "_fields"))
           if hasattr(s, mu_key)][0]
    want = torch.bfloat16 if moment_dtype else torch.float32
    assert all(t.dtype == want for t in TO.tree_leaves(tstate[mu_key]))
    _close_trees(tstate[mu_key], getattr(jmu, mu_key), atol=1e-7,
                 rtol=1e-2 if moment_dtype else 1e-6)
    if name == "adam":
        _close_trees(tstate["nu"], jmu.nu, atol=1e-9, rtol=1e-5)


# -------------------------------------------------------------- train step


def _jax_state(np_params, optimizer):
    return JT.create_train_state(jax.tree.map(jnp.asarray, np_params), optimizer)


def _optimizers(name="adam"):
    return (JO.build_optimizer(name, JO.build_schedule("none", LR, 30)),
            TO.build_optimizer(name, TO.build_schedule("none", LR, 30)))


def _check_metrics(tm, jm):
    for k in ("loss", "loss_i", "loss_t"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert bool(tm["finite"]) and bool(jm["finite"])


def _check_params(ours, ref, name, steps):
    atol = 1e-5 if name == "sgd" else 2 * LR * steps  # module docstring
    _close_trees(ours, ref, atol=atol)


def test_first_step_gradients_match(np_params):
    from clip_event_tpu.engine.train_step import loss_fn as jax_loss_fn

    batch = _batch(10)
    jgrads = jax.jit(jax.grad(lambda p: jax_loss_fn(
        p, jax.tree.map(jnp.asarray, batch), JCFG, "ce", True, False, False, jnp.float32
    )[0]))(jax.tree.map(jnp.asarray, np_params))
    params = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"),
                                   _optimizers()[1]).params
    total, _ = TT.loss_fn(params, _t(batch), TCFG, remat=True)
    grads = TO.tree_unflatten(params, torch.autograd.grad(total, TO.tree_leaves(params)))
    ours, ref = _flat(grads), _flat(jgrads)
    assert ours.keys() == ref.keys()
    for k in ours:
        err = np.abs(ours[k] - ref[k]).max()
        assert err <= 1e-5 * np.abs(ref[k]).max(), (k, err)


@pytest.mark.parametrize("name", ["sgd", "adam"])
@pytest.mark.parametrize("remat", [False, True])
def test_three_train_steps_match(np_params, remat, name):
    jopt, topt = _optimizers(name)
    jstep = JT.make_train_step(JCFG, jopt, donate=False, compute_dtype=jnp.float32, remat=remat)
    tstep = TT.make_train_step(TCFG, topt, compute_dtype=torch.float32, remat=remat)
    js = _jax_state(np_params, jopt)
    ts = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"), topt)
    for i in range(3):
        batch = _batch(10 + i)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, _t(batch))
        _check_metrics(tm, jm)
    assert ts.step == 3 and int(ts.opt_state["count"]) == 3
    _check_params(ts.params, js.params, name, steps=3)
    moved = max(np.abs(a - b).max() for a, b in
                zip(_flat(ts.params).values(), _flat(np_params).values()))
    assert moved > 1e-6


def test_accum_step_matches(np_params):
    jopt, topt = _optimizers("sgd")
    jstep = JT.make_accum_step(JCFG, jopt, 2, donate=False, compute_dtype=jnp.float32, remat=False)
    tstep = TT.make_accum_step(TCFG, topt, 2, compute_dtype=torch.float32, remat=True)
    js = _jax_state(np_params, jopt)
    ts = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"), topt)
    for i in range(2):
        micro = [_batch(20 + 2 * i), _batch(21 + 2 * i)]
        stacked = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        js, jm = jstep(js, jax.tree.map(jnp.asarray, stacked))
        ts, tm = tstep(ts, _t(stacked))
        _check_metrics(tm, jm)
    _check_params(ts.params, js.params, "sgd", steps=2)
    with pytest.raises(ValueError, match="accum_steps=2"):
        tstep(ts, _t({k: v[:1] for k, v in stacked.items()}))


def test_dedupe_path_equals_plain_path(np_params):
    """Encoding each unique token row once and gathering back gives the
    plain batch's loss and gradients (data/dedupe.py)."""
    batch = _batch(30)
    batch["text"][3:6] = batch["text"][0:3]  # image 1 repeats image 0's texts
    batch["text"][8] = batch["text"][7]
    unique, inverse = dedupe_rows(batch["text"], cap=12)
    deduped = dict(batch, text_unique=unique, text_inverse=inverse)
    del deduped["text"]
    params = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"),
                                   _optimizers()[1]).params
    leaves = TO.tree_leaves(params)
    results = []
    for b in (batch, deduped):
        total, parts = TT.loss_fn(params, _t(b), TCFG, remat=True)
        results.append((total.item(), parts, torch.autograd.grad(total, leaves)))
    assert abs(results[0][0] - results[1][0]) <= 1e-6
    for k in ("loss_i", "loss_t"):
        assert abs(results[0][1][k].item() - results[1][1][k].item()) <= 1e-6
    for a, b in zip(results[0][2], results[1][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_nonfinite_loss_freezes_the_state(np_params):
    """A non-finite loss keeps the old params and optimizer state (the
    step count included) and reports finite=False, as the JAX step does."""
    jopt, topt = _optimizers()
    tstep = TT.make_train_step(TCFG, topt, compute_dtype=torch.float32, remat=False)
    ts = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"), topt)
    ts, _ = tstep(ts, _t(_batch(40)))
    before = {k: v.copy() for k, v in _flat(ts.params).items()}
    mu_before = _flat(ts.opt_state["mu"])
    bad = _batch(41)
    bad["image"] = np.full((B, 32, 32, 3), np.nan, np.float32)
    ts, tm = tstep(ts, _t(bad))
    assert not bool(tm["finite"]) and not np.isfinite(float(tm["loss"]))
    assert ts.step == 2 and int(ts.opt_state["count"]) == 1
    for k, v in _flat(ts.params).items():
        np.testing.assert_array_equal(v, before[k])
    for k, v in _flat(ts.opt_state["mu"]).items():
        np.testing.assert_array_equal(v, mu_before[k])

    jstep = JT.make_train_step(JCFG, jopt, donate=False, compute_dtype=jnp.float32, remat=False)
    _, jm = jstep(_jax_state(np_params, jopt), jax.tree.map(jnp.asarray, bad))
    assert not bool(jm["finite"])
