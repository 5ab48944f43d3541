"""The port's fused LayerNorm (clip_event_tpu_torch.ops.ln, K4) and its
wiring (`transformer(ln=)`, `set_ln_impl`, `use_pallas_ln`) against the JAX
package, on the CPU: the same numpy inputs go through the JAX Pallas
kernels in interpret mode (`ops/ln_pallas.py`) and through the port, whose
wrappers run their plain versions on a CPU tensor.

Tolerances: forward fp32 1e-6 and bf16 2e-2 (one bf16 ulp at |y| < 4), the
fused add's sum exactly; gradients 1e-4 (fp32, sum orders differ); the
transformer stack's value rtol 1e-5 and gradients atol 2e-4, as
tests/test_ln_pallas.py holds the JAX kernels to its XLA LayerNorm; a train
step's loss 1e-5, grad_norm 1e-4 relative and params 1e-5 (SGD).

Model of the train-step and CLI tests: ViT towers of 2 layers, width 128
(the JAX kernels take widths that are multiples of 128 and fall back to the
XLA LayerNorm otherwise), 2 heads, patch 16, image 32, 77 tokens."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.engine.checkpoint import export_torch_checkpoint  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models import layers as JL  # noqa: E402
from clip_event_tpu.ops import ln_pallas as JLN  # noqa: E402
from clip_event_tpu_torch.config import ConfigError, validate_config  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.ops import ln as TLN  # noqa: E402
from clip_event_tpu_torch.ops import quant as TQ  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [(jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 2e-2)]
DTYPE_IDS = ["fp32", "bf16"]


@pytest.fixture(autouse=True)
def _default_ln_impl():
    """Every test starts from and leaves the default LayerNorm choice."""
    TL.set_ln_impl("xla")
    JL.set_ln_impl("xla")
    yield
    TL.set_ln_impl("xla")
    JL.set_ln_impl("xla")


def _inputs(shape, seed, n=1):
    rng = np.random.default_rng(seed)
    w = shape[-1]
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    scale = (1.0 + 0.1 * rng.normal(size=w)).astype(np.float32)
    bias = (0.1 * rng.normal(size=w)).astype(np.float32)
    return xs, scale, bias


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("jdt,tdt,atol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", [(4, 7, 128), (13, 256), (3, 5, 640)], ids=str)
def test_layer_norm_forward_matches_jax(shape, jdt, tdt, atol):
    (x,), scale, bias = _inputs(shape, 0)
    jx = jnp.asarray(x).astype(jdt)
    kernel = JLN.layer_norm_pallas(jx, jnp.asarray(scale), jnp.asarray(bias))
    xla = JL.layer_norm(jx, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})
    ours = TLN.fused_layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                                torch.from_numpy(bias))
    assert ours.dtype == tdt and tuple(ours.shape) == shape
    np.testing.assert_allclose(_np(ours), _np(kernel), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(ours), _np(xla), atol=atol, rtol=0)
    # the wrapper on a CPU tensor is the plain version, which is the port's
    # own LayerNorm
    tx = torch.from_numpy(x).to(tdt)
    plain = TLN.layer_norm_plain(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    assert torch.equal(ours, plain)
    own = TL.layer_norm(tx, {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(_np(ours), _np(own), atol=atol, rtol=0)


@pytest.mark.parametrize("jdt,tdt,atol", DTYPES, ids=DTYPE_IDS)
def test_add_layer_norm_forward_matches_jax(jdt, tdt, atol):
    (res, delta), scale, bias = _inputs((3, 11, 256), 5, n=2)
    jx, jy = JLN.add_layer_norm_pallas(jnp.asarray(res).astype(jdt), jnp.asarray(delta).astype(jdt),
                                       jnp.asarray(scale), jnp.asarray(bias))
    x, y = TLN.fused_add_layer_norm(torch.from_numpy(res).to(tdt), torch.from_numpy(delta).to(tdt),
                                    torch.from_numpy(scale), torch.from_numpy(bias))
    assert x.dtype == tdt and y.dtype == tdt
    # the sum is rounded to the I/O dtype before the LayerNorm reads it
    np.testing.assert_array_equal(_np(x), _np(jx))
    np.testing.assert_allclose(_np(y), _np(jy), atol=atol, rtol=0)
    assert torch.equal(y, TLN.layer_norm_plain(x, torch.from_numpy(scale), torch.from_numpy(bias)))


# --------------------------------------------------------------- gradients


def test_layer_norm_grad_matches_jax():
    (x, w), scale, bias = _inputs((6, 9, 128), 2, n=2)

    def loss(xx, s, b):
        return jnp.sum(JLN.layer_norm_pallas(xx, s, b) * jnp.asarray(w))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    ours = torch.autograd.grad((TLN.fused_layer_norm(*leaves) * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_x,use_y", [(True, True), (True, False), (False, True)],
                         ids=["both", "sum_only", "ln_only"])
def test_add_layer_norm_grad_matches_jax(use_x, use_y):
    """Both outputs carry cotangents, or one alone: the gradient of res and
    of delta is the sum's cotangent plus the LayerNorm's dx."""
    (res, delta, wx, wy), scale, bias = _inputs((5, 8, 128), 6, n=4)

    def loss(r, d, s, b):
        x, y = JLN.add_layer_norm_pallas(r, d, s, b)
        return use_x * jnp.sum(x * jnp.asarray(wx)) + use_y * jnp.sum(y * jnp.asarray(wy))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (res, delta, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (res, delta, scale, bias)]
    x, y = TLN.fused_add_layer_norm(*leaves)
    total = sum(t for t, used in (((x * torch.from_numpy(wx)).sum(), use_x),
                                  ((y * torch.from_numpy(wy)).sum(), use_y)) if used)
    ours = torch.autograd.grad(total, leaves, allow_unused=True)
    for a, b in zip(ours, ref):
        if a is None:  # scale and bias without a cotangent of y
            assert not use_y and not np.asarray(b).any()
            continue
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=0)
    assert torch.equal(ours[0], ours[1])


@pytest.mark.parametrize("with_dx_out", [False, True], ids=["ln", "add_ln"])
@pytest.mark.parametrize("shape", [(7, 5, 96), (4, 128)], ids=str)
def test_bwd_plain_equals_autograd_of_plain_fwd(shape, with_dx_out):
    """fp32 at 1e-5 (the plain backward computes in fp32 whatever it is
    given)."""
    (x, dy, dxo), scale, bias = _inputs(shape, 3, n=3)
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    tdy, tdxo = torch.from_numpy(dy), torch.from_numpy(dxo)
    y = TLN.layer_norm_plain(tx, ts, tb)
    outs, cots = ((tx * 1.0, y), (tdxo, tdy)) if with_dx_out else ((y,), (tdy,))
    ref = torch.autograd.grad(outs, (tx, ts, tb), cots)
    got = TLN.layer_norm_bwd_plain(tx.detach(), ts.detach(), tdy, tdxo if with_dx_out else None)
    assert got[0].shape == tx.shape and got[1].shape == got[2].shape == shape[-1:]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    # the wrapper on CPU tensors is this function
    again = TLN.fused_layer_norm_bwd(tx.detach(), ts.detach(), tdy, tdxo if with_dx_out else None)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bf16_backward_rounds_as_the_jax_kernels():
    """dx in x's dtype, dγ and dβ summed in fp32; with the sum's cotangent
    dx is rounded to bf16 first and added there."""
    (x, dy, dxo), scale, bias = _inputs((6, 128), 4, n=3)
    jx, jdy, jdxo = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy, dxo))
    _, vjp = jax.vjp(lambda r, d, s, b: JLN.add_layer_norm_pallas(r, d, s, b),
                     jx, jnp.zeros_like(jx), jnp.asarray(scale), jnp.asarray(bias))
    ref = vjp((jdxo, jdy))
    tx, tdy, tdxo = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy, dxo))
    din, dg, db = TLN.layer_norm_bwd_plain(tx, torch.from_numpy(scale), tdy, tdxo)
    assert din.dtype == torch.bfloat16 and dg.dtype == torch.float32 and db.dtype == torch.float32
    np.testing.assert_allclose(_np(din), _np(ref[0]), atol=2e-2, rtol=0)
    np.testing.assert_allclose(_np(dg), _np(ref[2]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(db), _np(ref[3]), atol=1e-4, rtol=0)


# ------------------------------------------------------ the transformer's ln


def _stack(L, W, seed):
    stacked = jax.tree.map(np.asarray, JL.init_transformer(jax.random.PRNGKey(seed), L, W))
    rng = np.random.default_rng(seed)
    for name in ("ln_1", "ln_2"):  # the init's LayerNorms are the identity
        stacked[name] = {"scale": (1 + 0.1 * rng.normal(size=(L, W))).astype(np.float32),
                         "bias": (0.1 * rng.normal(size=(L, W))).astype(np.float32)}
    return stacked


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in tree.items()}


def _leaves(tree):
    return [t for k in sorted(tree) for t in (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("remat", [False, "full"], ids=["saved", "remat"])
def test_transformer_ln_matches_jax_and_plain(remat):
    """transformer(ln="pallas") against JAX's transformer(ln=("pallas",
    None)) and against the port's own plain-LN run: value and every
    gradient, with and without per-block recompute."""
    stacked = _stack(2, 128, 9)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 16, 128)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(xx, pp):
        out = JL.transformer(xx, pp, 4, remat=remat, impl="xla", ln=("pallas", None))
        return jnp.sum(out * jnp.asarray(w))

    jv, (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, stacked))
    runs = {}
    for ln in ("pallas", "xla"):
        params = _torch_tree(stacked)
        tx = torch.from_numpy(x).requires_grad_(True)
        value = (TL.transformer(tx, params, 4, impl="plain", remat=remat, ln=ln) * torch.from_numpy(w)).sum()
        runs[ln] = (value.item(), torch.autograd.grad(value, [tx, *_leaves(params)]))
    ref_grads = [jgx, *_leaves(jgp)]
    for ln, (value, grads) in runs.items():
        np.testing.assert_allclose(value, float(jv), rtol=1e-5, err_msg=ln)
        assert len(grads) == len(ref_grads) == 13
        for a, b in zip(grads, ref_grads):
            np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=0, err_msg=ln)
    np.testing.assert_allclose(runs["pallas"][0], runs["xla"][0], rtol=1e-6)


def test_set_ln_impl_validates_resets_and_feeds_transformer():
    assert TL._resolve_ln() == "xla"
    with pytest.raises(ValueError, match="'xla' or 'pallas'"):
        TL.set_ln_impl("triton")
    # the port's data-parallel mesh is taken (each rank's kernels run on
    # its own rows: no wrapper); any other object is refused
    from clip_event_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TL.set_ln_impl("pallas", mesh=object())
    assert TL._resolve_ln() == "xla"
    TL.set_ln_impl("pallas", mesh=make_mesh("cpu"))
    assert TL._resolve_ln() == "pallas"
    TL.set_ln_impl("xla", mesh=make_mesh("cpu"))
    assert TL._resolve_ln() == "xla"
    with pytest.raises(ValueError, match="ln impl"):
        TL.transformer(torch.zeros(1, 3, 128), _torch_tree(_stack(1, 128, 0)), 2, impl="plain", ln="fused")

    # transformer(ln=None) takes the process-wide choice: an unsupported
    # width then raises (below), which tells the two settings apart
    wide = TLN.MAX_WIDTH + 64
    x = torch.zeros(1, 2, wide)
    params = {k: {kk: torch.zeros(1, *s) for kk, s in v.items()} for k, v in {
        "attn": {"qkv_w": (wide, 3 * wide), "qkv_b": (3 * wide,), "out_w": (wide, wide), "out_b": (wide,)},
        "ln_1": {"scale": (wide,), "bias": (wide,)}, "ln_2": {"scale": (wide,), "bias": (wide,)},
        "mlp": {"fc_w": (wide, 8), "fc_b": (8,), "proj_w": (8, wide), "proj_b": (wide,)}}.items()}
    assert TL.transformer(x, params, 1, impl="plain").shape == x.shape
    TL.set_ln_impl("pallas")
    assert TL._resolve_ln() == "pallas"
    with pytest.raises(ValueError, match="LayerNorm kernels take"):
        TL.transformer(x, params, 1, impl="plain")
    assert TL.transformer(x, params, 1, impl="plain", ln="xla").shape == x.shape
    TL.set_ln_impl("xla")
    assert TL.transformer(x, params, 1, impl="plain").shape == x.shape


def test_unsupported_width_raises_on_the_cpu():
    """A width the kernels do not take raises on every device, so a CPU run
    shows what the card would do (the JAX package warns and runs XLA)."""
    assert all(TLN.ln_supported(w) for w in (512, 640, 768, 1024, 1280, 100, 1, TLN.MAX_WIDTH))
    assert not TLN.ln_supported(TLN.MAX_WIDTH + 1) and not TLN.ln_supported(0)
    wide = TLN.MAX_WIDTH + 1
    x, v = torch.zeros(2, wide), torch.ones(wide)
    for call in (lambda: TLN.fused_layer_norm(x, v, v), lambda: TLN.fused_add_layer_norm(x, x, v, v),
                 lambda: TLN.fused_layer_norm_bwd(x, v, x)):
        with pytest.raises(ValueError, match=f"1 <= W <= {TLN.MAX_WIDTH}"):
            call()
    # the plain versions take any width
    assert TLN.layer_norm_plain(x, v, v).shape == x.shape


def test_launch_counters_stay_zero_on_the_cpu():
    before = (TLN.fused_layer_norm.launches, TLN.fused_add_layer_norm.launches,
              TLN.fused_layer_norm_bwd.launches)
    x = torch.randn(3, 64, requires_grad=True)
    v = torch.ones(64, requires_grad=True)
    s, y = TLN.fused_add_layer_norm(x, TLN.fused_layer_norm(x, v, v), v, v)
    (s.sum() + y.sum()).backward()
    assert before == (TLN.fused_layer_norm.launches, TLN.fused_add_layer_norm.launches,
                      TLN.fused_layer_norm_bwd.launches)
    assert TLN.BWD_LAUNCHES_PER_CALL == 2
    # the backward's grid: a few hundred row blocks at most, never more
    # than the rows need
    assert TLN.bwd_blocks(88704, 512, 132) == 528 and TLN.bwd_blocks(5, 512, 132) == 2
    assert TLN.bwd_blocks(10**6, TLN.MAX_WIDTH, 132) == 132


def test_calibration_pass_stays_plain(monkeypatch):
    """With `act_stats` given (int8 calibration) a block runs the plain
    LayerNorm whatever `ln` says, as the JAX package does."""
    calls = []
    monkeypatch.setattr(TLN, "fused_layer_norm", lambda *a, **k: calls.append("ln") or 1 / 0)
    monkeypatch.setattr(TLN, "fused_add_layer_norm", lambda *a, **k: calls.append("add") or 1 / 0)
    stacked = _torch_tree(_stack(1, 128, 1))
    layer = TL._layer(stacked, 0)
    x = torch.randn(2, 5, 128)
    stats = {}
    with torch.no_grad():
        out = TL.residual_block(x, layer, 2, None, "plain", stats, "pallas")
        ref = TL.residual_block(x, layer, 2, None, "plain", None, "xla")
    assert not calls and set(stats) == {"attn", "mlp"}
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    with pytest.raises(ZeroDivisionError):
        TL.residual_block(x, layer, 2, None, "plain", None, "pallas")
    assert calls == ["ln"]
    # and the whole calibration of a model runs under set_ln_impl("pallas")
    assert callable(TQ.calibrate_act_scales)


# ------------------------------------------------ train step and train CLI

CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=512,
    transformer_width=128, transformer_heads=2, transformer_layers=2,
)
B, D = 4, 3


def _batch(seed):
    rng = np.random.default_rng(seed)
    layout = build_label_layout(B, 1, 2)
    text = np.zeros((B * D, 77), np.int32)
    for i in range(B * D):
        eot = int(rng.integers(2, 40))
        text[i, 0] = 510
        text[i, 1:eot] = rng.integers(1, 510, eot - 1)
        text[i, eot] = 511
    return {"image": rng.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8), "text": text,
            "labels_per_image": layout.labels_per_image, "labels_per_text": layout.labels_per_text,
            "index_pos": layout.index_pos}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = _np(v)
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["saved", "remat"])
def test_train_steps_with_ln_kernels_match_jax(remat):
    """Two SGD steps with the LayerNorm kernels on in both packages
    (`set_ln_impl("pallas")`, what `use_pallas_ln` sets): loss, grad_norm
    and the updated params."""
    jcfg, tcfg = J.CLIPConfig(**CFG_KW), T.CLIPConfig(**CFG_KW)
    np_params = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    jopt = JO.build_optimizer("sgd", JO.build_schedule("none", 1e-4, 30))
    topt = TO.build_optimizer("sgd", TO.build_schedule("none", 1e-4, 30))
    JL.set_ln_impl("pallas")
    TL.set_ln_impl("pallas")
    jstep = JT.make_train_step(jcfg, jopt, donate=False, compute_dtype=jnp.float32, remat=remat)
    tstep = TT.make_train_step(tcfg, topt, compute_dtype=torch.float32, remat=remat)
    js = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), jopt)
    ts = TT.create_train_state(params_from_jax(np_params, tcfg, device="cpu"), topt)
    for i in range(2):
        batch = _batch(10 + i)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
        for k in ("loss", "loss_i", "loss_t"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    ours, ref = _flat(ts.params), _flat(js.params)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-5, rtol=0, err_msg=k)
    # and the port's step with the plain LayerNorm from the same start
    TL.set_ln_impl("xla")
    ps = TT.create_train_state(params_from_jax(np_params, tcfg, device="cpu"), topt)
    for i in range(2):
        ps, pm = tstep(ps, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _batch(10 + i).items()})
    np.testing.assert_allclose(float(pm["loss"]), float(tm["loss"]), atol=1e-5, rtol=0)


BASE_CFG = {"task": "t", "constrastive_loss": "ce", "batch_size": 2, "lr": 1e-4,
            "optimizer": "adam", "max_epoch": 1}


def test_use_pallas_ln_is_a_config_key():
    """No longer a refused key: the same validated config as the JAX
    package's, with the key on and off."""
    from clip_event_tpu import config as JC

    assert validate_config(BASE_CFG)["use_pallas_ln"] is False
    on = validate_config(dict(BASE_CFG, use_pallas_ln=True))
    assert on["use_pallas_ln"] is True and on == JC.validate_config(dict(BASE_CFG, use_pallas_ln=True))
    # with tensor and pipeline parallelism (the kernels on the local rows
    # under sp, inside the stages under pp) as in JAX; the refusal that
    # stays is JAX's own: pp < 1
    for extra in ({"tp": 2, "sp": True}, {"pp": 2}):
        cfg = dict(BASE_CFG, use_pallas_ln=True, **extra)
        assert validate_config(cfg) == JC.validate_config(cfg)
    with pytest.raises(ConfigError, match="pp must be a positive int"):
        validate_config(dict(BASE_CFG, use_pallas_ln=True, pp=0))


def _scalars(path):
    with open(path) as fh:
        return {(r["tag"], r["step"]): r["value"] for r in map(json.loads, fh)}


def test_train_cli_with_use_pallas_ln_matches_jax_cli(tmp_path):
    """`python -m clip_event_tpu_torch.train` with `use_pallas_ln: true`
    against `train.py` with the same key, from one `.pth`, on the synthetic
    VOA corpus: the epoch means of the losses agree to 1e-5; and the loop
    puts the process-wide LayerNorm choice back."""
    model = dict(CFG_KW, vocab_size=49408)
    voa = make_voa_fixture(str(tmp_path / "voa"))
    jcfg = J.CLIPConfig(**model)
    pth = str(tmp_path / "boot.pth")
    export_torch_checkpoint(pth, J.init_params(jax.random.PRNGKey(3), jcfg), jcfg, epoch=0, task="boot")
    base = {
        "task": "cli", "constrastive_loss": "ce", "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "max_epoch": 1, "batch_size": 2, "lr": 1e-4, "optimizer": "adam", "lr_scheduler": "none",
        "compute_dtype": "float32", "remat": True, "num_workers": 2, "jit": True, "begin_ckpt": pth,
        "use_pallas_ln": True,
    }
    runs = {}
    for name, extra, cmd, env in [
        ("jax", {"use_pallas_attention": False}, [sys.executable, "train.py"],
         dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")),
        ("port", {}, [sys.executable, "-m", "clip_event_tpu_torch.train", "--device", "cpu"],
         dict(os.environ)),
    ]:
        cfg = dict(base, ckpt_dir=str(tmp_path / f"ckpt_{name}"), tb_log_dir=str(tmp_path / f"logs_{name}"),
                   **extra)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        runs[name] = subprocess.Popen(cmd + ["--cfg", str(path)], cwd=REPO, env=env, text=True,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    for name, proc in runs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-3000:])
    ours = _scalars(tmp_path / "logs_port" / "cli" / "tensorboard" / "scalars.jsonl")
    ref = _scalars(tmp_path / "logs_jax" / "cli" / "tensorboard" / "scalars.jsonl")
    for tag in ("train_loss", "loss_i", "loss_t"):
        assert abs(ours[tag, 0] - ref[tag, 0]) <= 1e-5, (tag, ours, ref)
    with open(tmp_path / "logs_port" / "cli" / "tensorboard" / "config.json") as fh:
        assert json.load(fh)["use_pallas_ln"] is True


def test_train_loop_restores_the_ln_choice(tmp_path, monkeypatch):
    """`train()` selects the kernels for its own run and puts the previous
    choice back, also when the loop raises."""
    from clip_event_tpu_torch import train as train_mod
    from clip_event_tpu_torch.data.common import ExampleDataset

    seen = []

    class Tiny(ExampleDataset):
        def __len__(self):
            return 2

        def __getitem__(self, i):
            seen.append(TL._resolve_ln())
            raise RuntimeError("stop here")

    cfg = validate_config(dict(BASE_CFG, use_pallas_ln=True, num_workers=0,
                               ckpt_dir=str(tmp_path / "ckpt"), tb_log_dir=str(tmp_path / "logs")))
    tcfg = T.CLIPConfig(**CFG_KW)
    params = T.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(Exception):
        train_mod.train(cfg, tcfg, Tiny(), params, "cpu")
    assert seen and set(seen) == {"pallas"}
    assert TL._resolve_ln() == "xla"
