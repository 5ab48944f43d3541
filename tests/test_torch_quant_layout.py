"""K5's weight layout and its GEMM-alone entry on the CPU, against the JAX
package on numpy-seeded inputs: `QuantWeight.q` is K-major (the
transposed view of a contiguous [..., out, in] buffer, `stride(-2) == 1`)
with the JAX `q`'s values after every route that builds or carries one
(`quantize_weight`, slicing, `.to`, `tree_to` / `cast_params`, the `CLIP`
module's buffers, `params_from_jax`, a `state_dict` / `torch.save` round
trip); the plain GEMM alone (`quantized_gemm_plain`) against JAX's
`quantized_linear` pieces (integer sums equal, the rescaled output within
1e-5·max|y| fp32, one bf16 ulp of max|y| bf16); `padded_k` at the 128-byte
k tile; the weight operand the GEMM reads (no copy where TMA can read q's
rows, a zero-padded copy where it cannot); and the wrappers' refusals."""

import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.ops import quant as JQ  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.ops import quant as TQ  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=77, vocab_size=49408,
    transformer_width=64, transformer_heads=1, transformer_layers=2,
)
JCFG, TCFG = J.CLIPConfig(**CFG_KW), T.CLIPConfig(**CFG_KW)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jq():
    """A quantized JAX param tree (both towers, static scales on the dense
    layers that calibration reaches)."""
    params = J.init_params(jax.random.PRNGKey(0), JCFG)
    return _np(JQ.quantize_params(params))


def _quant_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _quant_leaves(v, path + (k,))
        elif isinstance(v, (TQ.QuantWeight, JQ.QuantWeight)):
            yield path + (k,), v


def _assert_k_major_as_jax(tree, jtree):
    """Every QuantWeight of `tree` stores q K-major, with no padding, and
    holds the values of the JAX tree's q at the same path."""
    ours, ref = dict(_quant_leaves(tree)), dict(_quant_leaves(jtree))
    assert set(ours) == set(ref) and len(ours) == 11
    for path, w in ours.items():
        assert w.q.dtype == torch.int8 and w.q.stride(-2) == 1 and TQ.is_k_major(w.q), path
        assert w.q.untyped_storage().nbytes() == w.q.numel(), path  # no byte more on the card
        np.testing.assert_array_equal(w.q.numpy(), ref[path].q, err_msg=str(path))


@pytest.mark.parametrize("shape", [(48, 96), (3, 32, 64), (588, 256)], ids=["2d", "stacked", "k588"])
def test_quantize_weight_stores_k_major(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = JQ.quantize_weight(jnp.asarray(w))
    ours = TQ.quantize_weight(torch.from_numpy(w))
    assert ours.q.shape == shape and ours.q.stride(-2) == 1
    assert ours.q.transpose(-1, -2).is_contiguous()
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    if len(shape) == 3:
        # slicing a stacked weight keeps the layout: layer i is K-major too
        layer = ours[2]
        assert layer.q.stride(-2) == 1 and torch.equal(layer.q, ours.q[2])
        np.testing.assert_array_equal(layer.q.numpy(), np.asarray(ref.q)[2])
    # k_major is the identity on a K-major q, and a QuantWeight built from
    # a row-major q makes it K-major
    assert TQ.k_major(ours.q) is ours.q
    rebuilt = TQ.QuantWeight(ours.q.contiguous(), ours.scale)
    assert rebuilt.q.stride(-2) == 1 and torch.equal(rebuilt.q, ours.q)


def test_params_from_jax_and_tree_helpers_keep_k_major(jq):
    tq = params_from_jax(jq, TCFG, "cpu")
    _assert_k_major_as_jax(tq, jq)
    _assert_k_major_as_jax(T.tree_to(tq, "cpu"), jq)
    _assert_k_major_as_jax(T.tree_to(tq, "cpu", torch.bfloat16), jq)
    _assert_k_major_as_jax(T.cast_params(tq), jq)
    w = tq["visual"]["transformer"]["mlp"]["fc_w"]
    moved = w.to("cpu")
    assert moved.q.stride() == w.q.stride()
    layer = TL._layer(tq["visual"]["transformer"], 1)["mlp"]["fc_w"]
    assert layer.q.stride(-2) == 1
    np.testing.assert_array_equal(layer.q.numpy(), jq["visual"]["transformer"]["mlp"]["fc_w"].q[1])


def test_clip_module_buffers_keep_k_major(jq):
    model = T.CLIP(TCFG, params_from_jax(jq, TCFG, "cpu"))
    buffers = dict(model.named_buffers())
    q = buffers["visual.transformer.attn.qkv_w.q"]
    assert q.stride(-2) == 1
    _assert_k_major_as_jax(model.params(), jq)
    _assert_k_major_as_jax(model.to("cpu").params(), jq)


def test_state_dict_and_save_round_trip_keep_k_major(jq):
    model = T.CLIP(TCFG, params_from_jax(jq, TCFG, "cpu"))
    buf = io.BytesIO()
    torch.save(model.state_dict(), buf)
    buf.seek(0)
    sd = torch.load(buf)
    assert sd["visual.transformer.mlp.fc_w.q"].stride(-2) == 1
    # into a module built from other weights: load_state_dict copies into
    # its K-major buffers
    other = _np(JQ.quantize_params(J.init_params(jax.random.PRNGKey(1), JCFG)))
    fresh = T.CLIP(TCFG, params_from_jax(other, TCFG, "cpu"))
    fresh.load_state_dict(sd)
    _assert_k_major_as_jax(fresh.params(), jq)
    # a QuantWeight pickled whole
    w = model.params()["text_projection"]
    buf = io.BytesIO()
    torch.save(w, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=False)
    assert back.q.stride() == w.q.stride() and torch.equal(back.q, w.q)


def _jax_pieces(x, w, b, act_absmax):
    """JAX's quantized_linear, step by step: (x_q, s_x, the int32 sums, y)."""
    jw = JQ.quantize_weight(jnp.asarray(w), act_absmax=act_absmax)
    x32 = jnp.asarray(x, jnp.float32)
    if jw.act_scale is not None:
        s_x = jnp.broadcast_to(jw.act_scale, (x.shape[0], 1))
    else:
        s_x = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-12)
    x_q = jnp.clip(jnp.round(x32 / s_x), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(x_q, jw.q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (s_x * jw.scale)
    if b is not None:
        y = y + jnp.asarray(b)
    return np.asarray(x_q), np.asarray(s_x).reshape(-1), np.asarray(acc), np.asarray(y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("m,k,n,bias", [(77, 64, 192, True), (1, 588, 256, True), (33, 48, 7, False)],
                         ids=["text", "m1_k588", "n_odd"])
def test_quantized_gemm_plain_matches_jax_pieces(m, k, n, bias, static, dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    absmax = float(np.abs(x).max()) * 0.8 if static else None
    jxq, js, jacc, jy = _jax_pieces(x, w, b, absmax)
    tw = TQ.quantize_weight(torch.from_numpy(w))
    xq, s = torch.from_numpy(jxq.copy()), torch.from_numpy(js.copy())
    tb = None if b is None else torch.from_numpy(b)
    # the integer sums: exact (|sum| < 2^24, so fp32 holds them)
    ones_m, ones_n = torch.ones(m), torch.ones(n)
    acc = TQ.quantized_gemm_plain(xq, ones_m, tw.q, ones_n)
    np.testing.assert_array_equal(acc.numpy(), jacc.astype(np.float32))
    # the rescaled output, in the working dtype
    td = DTYPES[dtype][1]
    y = TQ.quantized_gemm_plain(xq, s, tw.q, tw.scale, tb, td)
    assert y.dtype == td and tuple(y.shape) == (m, n)
    ref = jy.astype(np.float32)
    top, diff = np.abs(ref).max(), np.abs(y.float().numpy() - ref).max()
    assert diff <= (1e-5 * top if dtype == "float32" else np.exp2(np.floor(np.log2(top)) - 7)), diff
    # the row pass's padded rows give the same result, bit for bit
    padded = torch.zeros((m, TQ.padded_k(k)), dtype=torch.int8)
    padded[:, :k] = xq
    assert torch.equal(TQ.quantized_gemm_plain(padded, s, tw.q, tw.scale, tb, td), y)
    # and on a CPU tensor the wrapper is the plain version
    assert torch.equal(TQ.quantized_gemm(xq, s, tw.q, tw.scale, tb, td), y)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_quantized_matmul_plain_is_rows_then_gemm(static):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(9, 40)).astype(np.float32))
    w = TQ.quantize_weight(torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32)),
                           torch.tensor(2.5) if static else None)
    b = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32))
    xq, s = TQ.quantize_rows_plain(x, w.act_scale)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        xq, s = TQ.quantize_rows_plain(xd, w.act_scale)
        assert torch.equal(TQ.quantized_matmul_plain(xd, w.q, w.scale, b, w.act_scale),
                           TQ.quantized_gemm_plain(xq, s, w.q, w.scale, b, dtype))


def test_padded_k_at_the_128_byte_tile():
    assert TQ.K_TILE == 128
    assert [TQ.padded_k(k) for k in (1, 3, 100, 127, 128, 129, 200, 588, 768, 3072, 4096)] == [
        128, 128, 128, 128, 128, 256, 256, 640, 768, 3072, 4096]


@pytest.mark.parametrize("k,n,copied", [(64, 24, False), (1024, 7, False), (588, 20, True), (3, 7, True),
                                         (100, 131, True), (40, 1, True)])
def test_weight_operand(k, n, copied):
    """The [N, K'] rows the GEMM reads: q's own buffer where its rows start
    16-byte aligned, else a copy padded with zeros to padded_k(K)."""
    w = TQ.quantize_weight(torch.from_numpy(np.random.default_rng(13).normal(size=(k, n)).astype(np.float32)))
    held, ld = TQ.weight_operand(w.q)
    assert ld % TQ.TMA_ALIGN == 0 and held.data_ptr() % TQ.TMA_ALIGN == 0
    assert (held is not w.q) == copied
    # the bytes the GEMM reads: N rows of ld bytes, K of them the weight's
    rows = torch.as_strided(held, (n, ld), (ld, 1)) if not copied else held
    assert rows.shape == (n, TQ.padded_k(k) if copied else k)
    assert torch.equal(rows[:, :k], w.q.t()) and not rows[:, k:].any()


def test_wrapper_refusals():
    """On a device that is neither the CPU nor CUDA (meta), the wrappers
    raise and never run the plain version; a q that is not K-major is
    refused before anything else (K5 makes no hidden transposed copy)."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    w = TQ.quantize_weight(torch.from_numpy(rng.normal(size=(64, 24)).astype(np.float32)))
    xq, s = TQ.quantize_rows_plain(x)
    row_major = w.q.contiguous()
    assert not TQ.is_k_major(row_major)
    meta = {name: t.to("meta") for name, t in
            (("x", x), ("q", w.q), ("rm", row_major), ("scale", w.scale), ("xq", xq), ("s", s))}
    assert meta["q"].stride() == w.q.stride() and meta["rm"].stride() == row_major.stride()
    with pytest.raises(ValueError, match="K-major"):
        TQ.quantized_matmul(meta["x"], meta["rm"], meta["scale"])
    with pytest.raises(ValueError, match="K-major"):
        TQ.quantized_gemm(meta["xq"], meta["s"], meta["rm"], meta["scale"])
    with pytest.raises(ValueError, match="CUDA"):
        TQ.quantized_matmul(meta["x"], meta["q"], meta["scale"])
    with pytest.raises(ValueError, match="CUDA"):
        TQ.quantized_gemm(meta["xq"], meta["s"], meta["q"], meta["scale"])
    with pytest.raises(ValueError, match="CUDA"):
        TQ.quantize_rows(meta["x"])
    # a row-major q on the CPU still takes the plain version (any layout)
    assert torch.equal(TQ.quantized_matmul(x, row_major, w.scale), TQ.quantized_matmul_plain(x, w.q, w.scale))
