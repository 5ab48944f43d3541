"""The timed callables of the port's component bench sections (`matmul`,
`quantgemm`, `text`, `vision`, `visionsplit`, `textsplit`, `step`,
`textwidth`, `latency`, `quant`, `ot`) against the JAX expressions that the
JAX tool's sections time (root `tools/bench_components.py`), on the same
weights (JAX's init, carried over by `params_from_jax`) and the same
inputs, in fp32 on the CPU. The JAX side runs its plain attention and its
XLA int8 composition (the Pallas kernels' references); the port's kernel
variants run their plain versions here.

Bars: tower and stack gradients, their losses and the encodes within 1e-4
of the largest reference value of each tensor; the train step's loss and
grad_norm within 1e-5; OT within 1e-5; the int8 paths as
tests/test_torch_quant.py holds them (the products within 1e-5 of
max|y| in fp32 and one bf16 ulp of it in bf16, the quantized rows and the
integer product exactly, the int8 encoders within 1e-4 on inputs whose
quantized activations sit on no rounding boundary). Model: the tiny
`MODEL` of tests/test_torch_bench.py with one layer a tower (`--layers
1`, as tests/test_torch_bench_sections.py runs the sections)."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.data.labels import build_label_layout as j_layout  # noqa: E402
from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models import layers as JL  # noqa: E402
from clip_event_tpu.models import vit as JV  # noqa: E402
from clip_event_tpu.ops import ot as JOT  # noqa: E402
from clip_event_tpu.ops import quant as JQ  # noqa: E402
from clip_event_tpu_torch.engine.optim import tree_unflatten  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.ops import quant as TQ  # noqa: E402
from clip_event_tpu_torch.tools import bench_components as BC  # noqa: E402

from tests.test_torch_bench import MODEL  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

# MODEL at `--layers 1`, the model tests/test_torch_bench_sections.py runs
# the sections on
KW = dict(json.loads(MODEL), vision_layers=1, transformer_layers=1)
JCFG, TCFG = J.CLIPConfig(**KW), T.CLIPConfig(**KW)
F32 = torch.float32
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jparams():
    init = jax.jit(lambda key: J.init_params(key, JCFG))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jparams, TCFG, "cpu")


def _close(ours, ref, bar=1e-4, what=""):
    """max |ours - ref| <= bar · max |ref|."""
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, what
    assert np.abs(ours - ref).max() <= bar * np.abs(ref).max(), (what, np.abs(ours - ref).max())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _check_grads(loss, grads, like, jloss, jgrads):
    """The port's (loss, grads in `like`'s leaf order; None where a leaf is
    not read) against JAX's value and gradient tree."""
    _close(loss, jloss, what="loss")
    ours, ref = _flat(tree_unflatten(like, list(grads))), _flat(jgrads)
    assert ours.keys() == ref.keys()
    for k, g in ours.items():
        if g is None:
            assert not np.asarray(ref[k]).any(), k
        else:
            _close(g, ref[k], what=k)


def _np(t):
    return t.numpy()


# ------------------------------------------------------------ products


def test_matmul_call_matches_jnp_dot():
    gen = BC._gen(CPU)
    for name, m, k, n in BC.matmul_shapes(TCFG, 2):
        a, b = torch.randn((m, k), generator=gen), torch.randn((k, n), generator=gen)
        ref = jnp.dot(jnp.asarray(_np(a)), jnp.asarray(_np(b)), preferred_element_type=jnp.float32)
        _close(BC.matmul_call(a, b, F32)(), ref, 1e-5, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantgemm_calls_match_jax(dtype):
    tdt, jdt = {"float32": (F32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    gen = BC._gen(CPU)
    JQ.set_gemm_impl("xla")  # JAX's plain composition (its Pallas kernel's reference)
    try:
        for name, m, k, n in BC.quantgemm_shapes(TCFG, 2):
            x, w = torch.randn((m, k), generator=gen), torch.randn((k, n), generator=gen)
            calls = BC.quantgemm_calls(x, w, tdt)
            jx = jnp.asarray(_np(x)).astype(jdt)
            jqw = JQ.quantize_weight(jnp.asarray(_np(w)))
            ref = np.asarray(JQ.quantized_linear(jx, jqw).astype(jnp.float32))
            top, bar = np.abs(ref).max(), 1e-5 if dtype == "float32" else None
            bar = bar * top if bar else np.exp2(np.floor(np.log2(top)) - 7)
            for variant in ("int8 plain", "K5", "K5 GEMM alone"):
                y = calls[variant]()
                assert y.dtype == tdt
                assert np.abs(y.float().numpy() - ref).max() <= bar, (name, variant)
            # the row pass and the integer product: JAX's row quantization
            x32 = jx.astype(jnp.float32)
            s = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-12)
            jxq = np.asarray(jnp.clip(jnp.round(x32 / s), -127, 127).astype(jnp.int8))
            xq, rs = calls["K5 row pass"]()
            assert np.array_equal(xq.numpy(), jxq)
            np.testing.assert_allclose(rs.numpy(), np.asarray(s)[:, 0], rtol=1e-7, atol=0)
            acc = jxq.astype(np.int64) @ np.asarray(jqw.q).astype(np.int64)
            assert np.array_equal(calls["torch._int_mm"]().numpy(), acc)
            if dtype == "float32":
                _close(calls["mm"](), jnp.dot(jx, jnp.asarray(_np(w))), 1e-5, name)
    finally:
        JQ.set_gemm_impl("auto")


# -------------------------------------------------------------- towers


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_tower_grad_calls_match_jax(jparams, tparams, tower):
    gen = BC._gen(CPU)
    if tower == "text":
        x = BC.text_tokens(TCFG, 2 * BC.D, TCFG.context_length, gen, CPU)
        enc = J.encode_text
    else:
        x = BC.images(TCFG, 2, gen, CPU)
        enc = J.encode_image
    jx = jnp.asarray(_np(x))

    def loss(p):
        return jnp.sum(enc(p, JCFG, jx, compute_dtype=jnp.float32).astype(jnp.float32) ** 2) * 1e-6

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, jparams))
    for label, remat, impl in BC.TOWER_VARIANTS:
        loss_t, grads = BC.tower_grad_call(tparams, TCFG, x, tower, remat, impl, F32)()
        _check_grads(loss_t, grads, tparams, jloss, jgrads)


def _jax_blocks(H, bias):
    """The JAX tool's split blocks (`bench_visionsplit`, `bench_textsplit`)."""
    def mlp(h, lp):
        hh = JL.linear(JL.layer_norm(h, lp["ln_2"]), lp["mlp"]["fc_w"], lp["mlp"]["fc_b"])
        return h + JL.linear(JL.quick_gelu(hh), lp["mlp"]["proj_w"], lp["mlp"]["proj_b"])

    def skeleton(h, lp):
        q = JL.linear(h, lp["attn"]["qkv_w"], lp["attn"]["qkv_b"])[..., :h.shape[-1]]
        q = JL.linear(q, lp["attn"]["out_w"], lp["attn"]["out_b"])
        hh = JL.linear(h + q, lp["mlp"]["fc_w"], lp["mlp"]["fc_b"])
        return h + JL.linear(hh, lp["mlp"]["proj_w"], lp["mlp"]["proj_b"])

    block = lambda h, lp: JL.residual_block(h, lp, H, bias, impl="xla")  # noqa: E731
    attention = lambda h, lp: h + JL.multi_head_attention(  # noqa: E731
        JL.layer_norm(h, lp["ln_1"]), lp["attn"], H, bias, impl="xla")
    return {"full block": block, "mlp half": mlp, "attention half": attention, "matmul skeleton": skeleton}


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_stack_grad_calls_match_jax(tower):
    _, L, W, H, S, n, causal = next(t for t in BC.tower_shapes(TCFG, 2) if t[0] == tower)
    jstack = jax.tree.map(np.asarray, JL.init_transformer(jax.random.PRNGKey(0), L, W))
    stacked = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in jstack.items()}
    x = torch.randn((n, S, W), generator=BC._gen(CPU))
    blocks = BC.split_blocks(H, TL.causal_mask(S, device="cpu") if causal else None)
    jblocks = _jax_blocks(H, JL.causal_mask(S) if causal else None)
    names = BC.TEXTSPLIT if tower == "text" else BC.VISIONSPLIT
    refs = {}
    for name in names:
        key = name.split(" (")[0]  # the plain and the kernel attention: one JAX expression
        if key not in refs:
            def loss(p, _b=jblocks[key]):
                h = jnp.asarray(_np(x))
                for i in range(L):
                    h = _b(h, jax.tree.map(lambda a, _i=i: a[_i], p))
                return jnp.sum(h ** 2) * 1e-6

            refs[key] = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, jstack))
        jloss, jgrads = refs[key]
        loss_t, grads = BC.stack_grad_call(stacked, x, blocks[name], F32)()
        _check_grads(loss_t, grads, stacked, jloss, jgrads)


def test_patch_embed_grad_call_matches_jax(jparams, tparams):
    imgs = BC.images(TCFG, 2, BC._gen(CPU), CPU)
    p = TCFG.vision_patch_size

    def loss(w):
        return jnp.sum(JV.patch_embed(jnp.asarray(_np(imgs)), w, p) ** 2) * 1e-6

    jloss, jgrad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(jparams["visual"]["patch_embed_w"]))
    loss_t, grad = BC.patch_embed_grad_call(tparams["visual"]["patch_embed_w"], imgs, p, F32)()
    _close(loss_t, jloss, what="loss")
    _close(grad, jgrad, what="grad")


# ---------------------------------------------------------------- step


def test_step_call_matches_jax(jparams, tparams):
    """Two steps a call from a fresh state: each step's loss and grad_norm
    against JAX's `make_multi_step` on the same batch (the step section's)."""
    data = BC.step_batch(TCFG, 2, CPU)
    layout = j_layout(2, 1, BC.D - 1, "ce", True)
    for k in ("labels_per_image", "labels_per_text", "index_pos"):
        assert np.array_equal(_np(data[k]), np.asarray(getattr(layout, k))), k
    jopt = JO.build_optimizer("adam", JO.build_schedule("none", 1e-6, 30))
    _, run_k = JT.make_multi_step(JCFG, jopt, 2, loss_type="ce", overbatch=True,
                                  compute_dtype=jnp.float32, remat=True, donate=False)
    _, jm = run_k(JT.create_train_state(jax.tree.map(jnp.asarray, jparams), jopt),
                  {k: jnp.asarray(_np(v)) for k, v in data.items()})
    for impl in ("plain", "kernel"):
        m = BC.step_call(TCFG, tparams, data, impl, 2, F32)()
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)


# ------------------------------------------------------------- encodes


def test_text_encode_call_matches_jax(jparams, tparams):
    gen = BC._gen(CPU)
    encode = jax.jit(lambda p, t: J.encode_text(p, JCFG, t, compute_dtype=jnp.float32))
    for width in (16, 8):
        tokens = BC.text_tokens(TCFG, 8, width, gen, CPU)
        ref = encode(jparams, jnp.asarray(_np(tokens)))
        _close(BC.text_encode_call(tparams, TCFG, tokens, F32)(), ref, what=f"width {width}")


def _jax_encoders(tree):
    image_fn, text_fn = JT.make_eval_encoders(JCFG, compute_dtype=jnp.float32)
    return {"image": lambda x: image_fn(tree, jnp.asarray(_np(x))),
            "text": lambda x: text_fn(tree, jnp.asarray(_np(x)))}


def test_encode_calls_match_jax(jparams, tparams):
    """The latency and quant sections' encodes: float, int8 dynamic (plain
    and K5's plain version) and int8 static, on JAX's trees."""
    gen = BC._gen(CPU)
    inputs = {"image": BC.images(TCFG, 4, gen, CPU), "text": BC.caption_tokens(TCFG, 4, gen, CPU)}
    # the static tree as both sections make it, against JAX's calibration
    calib_i, calib_t = BC.images(TCFG, 16, gen, CPU), BC.caption_tokens(TCFG, 16, gen, CPU)
    ours = BC.static_int8_params(tparams, TCFG, calib_i, calib_t)
    jstats = JQ.calibrate_act_scales(jparams, JCFG, [_np(calib_i)], [_np(calib_t)])
    quantize = jax.jit(lambda p, stats: JQ.quantize_params(p, act_stats=stats))
    jstatic = quantize(jparams, jstats)
    for k, w in _flat(jstatic).items():
        if isinstance(w, JQ.QuantWeight):
            mine = _flat(ours)[k]
            assert np.array_equal(mine.q.numpy(), np.asarray(w.q)), k
            np.testing.assert_allclose(mine.act_scale.numpy(), np.asarray(w.act_scale), rtol=1e-5, err_msg=k)
    trees = {"float": jparams, "int8 dynamic": quantize(jparams, None), "int8 static": jstatic}
    for label, jtree in trees.items():
        ttree = params_from_jax(jax.tree.map(np.asarray, jtree), TCFG, "cpu")
        ref = _jax_encoders(jtree)
        for tower, x in inputs.items():
            want = np.asarray(ref[tower](x))
            for gemm in ("xla", "pallas"):
                got = BC.encode_call(ttree, TCFG, x, tower, gemm, F32)()
                np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0, err_msg=f"{label} {tower}")
    assert TQ._GEMM_IMPL == "auto"


# ------------------------------------------------------------------ ot


def test_ot_call_matches_jax():
    txt, img, txt_pad, img_pad = BC.ot_inputs(8, BC._gen(CPU), CPU)
    assert not txt_pad[:, 0].any() and not img_pad[:, 0].any() and txt_pad.any() and img_pad.any()
    dist = jax.jit(lambda *a: JOT.optimal_transport_dist(*a, safe=True, use_pallas=False))
    ref = dist(*(jnp.asarray(_np(t)) for t in (txt, img, txt_pad, img_pad)))
    for use_kernel in (False, True):
        got = BC.ot_call(txt, img, txt_pad, img_pad, use_kernel)()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
