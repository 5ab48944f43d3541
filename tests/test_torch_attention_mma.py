"""The plain versions of the tensor-core ("mma") variants of K2 and K1 on
the CPU, and the rule that picks the variant. The kernels themselves run
on the card only (`chip_smoke.py` and `tests/test_torch_card.py` hold them
there); here:

(a) `mma_rounding=False` is bit-equal to the plain versions without the
    keyword (the fp32-inside reference the other CPU tests hold against JAX);
(b) in fp32 `mma_rounding=True` changes nothing but the sum order (fp32
    rounds to itself) and still matches the JAX head-grid Pallas kernel in
    interpret mode at 1e-5, forward and gradient, on numpy-seeded inputs;
(c) in bf16, at one head group of the path shapes (S = 257 and 197 at
    D = 64; D = 32 and 128 at S = 150), the rounded version is within
    1e-2 of max|plain| of the fp32-inside version, forward and backward:
    the gate the card holds the kernel to is reachable;
(d) `headgrid_variant` over dtypes and head dims (its fp32 variant,
    "tf32x3", has tests of its own: `test_torch_attention_tf32x3.py`);
(e) the wrapper refuses a qkv (or do) that is not 16-byte aligned on the
    mma variant, and takes any alignment on the simt variants;
(f) the same for K1 (S <= 128): `k1_variant`; its path shapes (S = 77
    causal and S = 50 without a bias at D = 64) and its tile edges (S = 1,
    16, 17, 65, 128; D = 16, 32, 128) in fp32 against the JAX K1 Pallas
    kernel in interpret mode at 1e-5 with `mma_rounding=True`, and in bf16
    within the card's gates of the unrounded version; `_FusedAttention` on
    the CPU saves (qkv, bias) alone."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops.attention_pallas import (  # noqa: E402
    fused_attention_qkv as jax_fused,
    fused_attention_qkv_headgrid as jax_headgrid,
)
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

ATOL = 1e-5
MMA_GATE = 1e-2  # of max|plain|


def _inputs(B, S, W, causal, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    do = rng.normal(size=(B, S, W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return torch.from_numpy(qkv), torch.from_numpy(do), None if bias is None else torch.from_numpy(bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_default_is_the_unrounded_plain_version(dtype, causal):
    qkv, do, bias = _inputs(2, 37, 128, causal)
    qkv, do = qkv.to(dtype), do.to(dtype)
    H, scale = 4, 32 ** -0.5
    out = TA.fused_attention_qkv_plain(qkv, bias, H, scale)
    assert torch.equal(out, TA.fused_attention_qkv_plain(qkv, bias, H, scale, mma_rounding=False))
    # the formulas written out, as the versions before the keyword had them
    x = qkv.float().view(2, 37, 3, H, 32)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    assert torch.equal(out, torch.matmul(p, v).transpose(1, 2).reshape(2, 37, 128).to(dtype))
    g = do.float().view(2, 37, H, 32).transpose(1, 2)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    want = torch.stack([t.transpose(1, 2) for t in (torch.matmul(ds, k) * scale,
                                                    torch.matmul(ds.transpose(-1, -2), q) * scale, dv)],
                       dim=2).reshape(2, 37, 384).to(dtype)
    grad = TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale)
    assert torch.equal(grad, want)
    assert torch.equal(grad, TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, mma_rounding=False))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,W,H", [(2, 13, 128, 2), (1, 150, 256, 8), (1, 257, 128, 2)])
def test_fp32_rounding_is_a_no_op_and_matches_pallas_interpret(B, S, W, H, causal):
    qkv, do, bias = _inputs(B, S, W, causal)
    scale = (W // H) ** -0.5
    jb = None if bias is None else jnp.asarray(bias.numpy())
    ref, vjp = jax.vjp(lambda x: jax_headgrid(x, jb, H, scale, True), jnp.asarray(qkv.numpy()))
    (ref_grad,) = vjp(jnp.asarray(do.numpy()))
    out = TA.fused_attention_qkv_plain(qkv, bias, H, scale, mma_rounding=True)
    grad = TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, mma_rounding=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=ATOL, rtol=0)
    # against the unrounded version only the order of two operations differs
    # (divide after the product; rowsum(do∘out) for rowsum(dp∘P))
    np.testing.assert_allclose(out.numpy(), TA.fused_attention_qkv_plain(qkv, bias, H, scale).numpy(),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(),
                               TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["nobias", "causal"])
@pytest.mark.parametrize("S,D", [(257, 64), (197, 64), (150, 32), (150, 128)])
def test_bf16_rounded_version_is_within_the_card_gate(S, D, causal):
    H = 2
    W = H * D
    qkv, do, bias = _inputs(1, S, W, causal, seed=S + D)
    qkv, do = qkv.to(torch.bfloat16), do.to(torch.bfloat16)
    scale = D ** -0.5
    plain = TA.fused_attention_qkv_plain(qkv, bias, H, scale).float()
    rounded = TA.fused_attention_qkv_plain(qkv, bias, H, scale, mma_rounding=True).float()
    assert rounded.shape == (1, S, W) and bool(torch.isfinite(rounded).all())
    rel = ((rounded - plain).abs().max() / plain.abs().max()).item()
    assert rel <= MMA_GATE, rel
    assert (rounded - plain).abs().max().item() <= 2e-2  # and the absolute gate
    plain = TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale).float()
    rounded = TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, mma_rounding=True).float()
    assert rounded.shape == (1, S, 3 * W) and bool(torch.isfinite(rounded).all())
    rel = ((rounded - plain).abs().max() / plain.abs().max()).item()
    assert rel <= MMA_GATE, rel
    # the rounding is real: the two versions are not the same function in bf16
    assert not torch.equal(rounded, plain)


def test_headgrid_variant_rule():
    for D in (16, 32, 64, 128):
        assert TA.headgrid_variant(torch.bfloat16, D) == "mma"
        assert TA.headgrid_variant(torch.float32, D) == "tf32x3"
    for D in (1, 2, 4, 8):  # the other head dims that divide 128
        assert TA.headgrid_variant(torch.bfloat16, D) == "simt"
        assert TA.headgrid_variant(torch.float32, D) == "simt"
    assert TA.headgrid_variant(torch.float16, 64) == "simt"  # refused later, by dtype
    assert TA.MMA_HEAD_DIMS == (16, 32, 64, 128) and TA.VARIANTS == ("mma", "tf32x3", "simt")
    assert TA.HG_BWD_LAUNCHES_PER_CALL == 2
    # every head dim K2 takes has a variant, and the path shapes take the
    # tensor cores in both dtypes
    for W, H in ((1024, 16), (768, 12)):
        assert TA.head_grid_supported(257, W, H) and TA.headgrid_variant(torch.bfloat16, W // H) == "mma"
        assert TA.headgrid_variant(torch.float32, W // H) == "tf32x3"


def _misaligned(shape, dtype):
    """A contiguous tensor whose data_ptr is one element past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("which", ["qkv", "do"])
def test_mma_variant_refuses_a_misaligned_tensor(which):
    B, S, W, H = 1, 130, 128, 2
    qkv = torch.zeros((B, S, 3 * W), dtype=torch.bfloat16)
    do = torch.zeros((B, S, W), dtype=torch.bfloat16)
    if which == "qkv":
        qkv = _misaligned((B, S, 3 * W), torch.bfloat16)
    else:
        do = _misaligned((B, S, W), torch.bfloat16)
    with pytest.raises(ValueError, match=f"needs {which} aligned to 16 bytes"):
        TA._check_kernel_input(qkv, None, H, do, head_grid=True)
    # aligned tensors pass the alignment check and stop at the device check
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv.clone(), None, H, do.clone(), head_grid=True)


def test_simt_variant_and_k1_take_any_alignment():
    qkv = _misaligned((1, 130, 384), torch.float32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv, None, 16, head_grid=True)  # fp32, head_dim 8: simt
    qkv = _misaligned((1, 130, 3 * 128), torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv, None, 16, head_grid=True)  # bf16, head_dim 8: simt
    # K1's simt variant: fp32 and bf16 with a head_dim no tensor-core
    # variant takes (40; fp32 at head_dim 64 takes tf32x3 now)
    qkv = _misaligned((1, 13, 240), torch.float32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv, None, 2)
    qkv = _misaligned((1, 13, 240), torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv, None, 2)


def test_headgrid_function_on_the_cpu_saves_no_residuals():
    """On a CPU tensor K2 runs its plain versions and saves qkv and bias
    alone; the backward takes `out` and `lse` as optional keywords."""
    qkv, do, bias = _inputs(1, 130, 128, True)
    x = qkv.clone().requires_grad_(True)
    out = TA.fused_attention_qkv_headgrid(x, bias, 2, 0.125)
    assert len(out.grad_fn.saved_tensors) == 2
    (grad,) = torch.autograd.grad(out, x, do)
    direct = TA.fused_attention_qkv_headgrid_bwd(qkv, bias, do, 2, 0.125, out=None, lse=None)
    assert torch.equal(grad, direct)
    assert TA.fused_attention_qkv_headgrid.launches == 0
    assert TA.fused_attention_qkv_headgrid_bwd.launches == 0


# K1 (S <= 128): (B, S, W, H, causal). The path shapes at a reduced batch
# (text S = 77 causal, ViT-B/32 vision S = 50 without a bias, D = 64), then
# the tile edges of the mma variant: one row (S = 1), one warp (16), a row
# past it (17), a row past four warps (65), eight warps (128), and head_dim
# 16, 32 and 128
K1_SHAPES = [
    (2, 77, 128, 2, True), (2, 50, 128, 2, False), (2, 1, 128, 2, False), (2, 16, 128, 2, True),
    (2, 17, 128, 2, False), (1, 65, 128, 2, True), (1, 128, 128, 2, False),
    (2, 40, 64, 4, True), (2, 40, 128, 4, False), (1, 77, 256, 2, True),
]
K1_IDS = [f"S{S}_D{W // H}_{'causal' if c else 'nobias'}" for _, S, W, H, c in K1_SHAPES]


def test_k1_variant_rule():
    for D in (16, 32, 64, 128):
        assert TA.k1_variant(torch.bfloat16, D) == "mma"
        assert TA.k1_variant(torch.float32, D) == "tf32x3"
    for D in (1, 8, 20, 40, 48, 96, 127):  # head dims K1 takes that no mma tile fits
        assert TA.k1_variant(torch.bfloat16, D) == "simt"
        assert TA.k1_variant(torch.float32, D) == "simt"
    assert TA.k1_variant(torch.float16, 64) == "simt"  # refused later, by dtype
    assert TA.VARIANTS == ("mma", "tf32x3", "simt")
    # one backward launch on the tensor cores (every tile of a head fits one
    # block; tf32x3's four fp32 tiles up to head_dim 64), two passes on the
    # CUDA cores
    assert [TA.bwd_launches_per_call(v, 64) for v in TA.VARIANTS] == [1, 1, 2]
    assert [TA.bwd_launches_per_call(v, 128) for v in TA.VARIANTS] == [1, 2, 2]
    # every head dim of the K1 path shapes takes the tensor cores: the text
    # towers (512 / 8, 768 / 12) and the ViT-B/32 vision tower (768 / 12)
    for W, H in ((512, 8), (768, 12)):
        assert TA.k1_variant(torch.bfloat16, W // H) == "mma"
        assert TA.k1_variant(torch.float32, W // H) == "tf32x3"
    for D in range(1, TA.MAX_HEAD_DIM + 1):
        for dtype in (torch.bfloat16, torch.float32):
            assert TA.k1_variant(dtype, D) == TA.headgrid_variant(dtype, D)


@pytest.mark.parametrize("B,S,W,H,causal", K1_SHAPES, ids=K1_IDS)
def test_k1_fp32_rounding_matches_pallas_interpret(B, S, W, H, causal):
    qkv, do, bias = _inputs(B, S, W, causal, seed=S)
    scale = (W // H) ** -0.5
    jb = None if bias is None else jnp.asarray(bias.numpy())
    ref, vjp = jax.vjp(lambda x: jax_fused(x, jb, H, scale, True), jnp.asarray(qkv.numpy()))
    (ref_grad,) = vjp(jnp.asarray(do.numpy()))
    out = TA.fused_attention_qkv_plain(qkv, bias, H, scale, mma_rounding=True)
    grad = TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, mma_rounding=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,S,W,H,causal", K1_SHAPES, ids=K1_IDS)
def test_k1_bf16_rounded_version_is_within_the_card_gate(B, S, W, H, causal):
    qkv, do, bias = _inputs(B, S, W, causal, seed=S + W)
    qkv, do = qkv.to(torch.bfloat16), do.to(torch.bfloat16)
    scale = (W // H) ** -0.5
    plain = TA.fused_attention_qkv_plain(qkv, bias, H, scale).float()
    rounded = TA.fused_attention_qkv_plain(qkv, bias, H, scale, mma_rounding=True).float()
    assert rounded.shape == (B, S, W) and bool(torch.isfinite(rounded).all())
    assert ((rounded - plain).abs().max() / plain.abs().max()).item() <= MMA_GATE
    assert (rounded - plain).abs().max().item() <= 2e-2  # and the absolute gate
    plain = TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale).float()
    rounded = TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, mma_rounding=True).float()
    assert rounded.shape == (B, S, 3 * W) and bool(torch.isfinite(rounded).all())
    assert ((rounded - plain).abs().max() / plain.abs().max()).item() <= MMA_GATE
    if S >= 16:
        # the rounding is real: the two versions are not the same function
        # in bf16 (at S = 1, P = 1 rounds to itself)
        assert not torch.equal(rounded, plain)


@pytest.mark.parametrize("which", ["qkv", "do"])
def test_k1_mma_variant_refuses_a_misaligned_tensor(which):
    B, S, W, H = 2, 77, 512, 8  # the text tower's shape: head_dim 64, mma in bf16
    qkv = torch.zeros((B, S, 3 * W), dtype=torch.bfloat16)
    do = torch.zeros((B, S, W), dtype=torch.bfloat16)
    if which == "qkv":
        qkv = _misaligned((B, S, 3 * W), torch.bfloat16)
    else:
        do = _misaligned((B, S, W), torch.bfloat16)
    with pytest.raises(ValueError, match=f"needs {which} aligned to 16 bytes"):
        TA._check_kernel_input(qkv, None, H, do)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv.clone(), None, H, do.clone())


def test_k1_function_on_the_cpu_saves_no_residuals():
    """On a CPU tensor K1 runs its plain versions and saves qkv and bias
    alone, whichever impl; the backward takes `out` and `lse` as optional
    keywords and launches nothing."""
    qkv, do, bias = _inputs(2, 77, 128, True)
    qkv, do = qkv.to(torch.bfloat16), do.to(torch.bfloat16)
    before = (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches)
    for impl in TA.IMPLS:
        x = qkv.clone().requires_grad_(True)
        out = TA.attend(x, bias, 2, 0.125, impl=impl)
        assert len(out.grad_fn.saved_tensors) == 2
        if impl == "kernel":
            (grad,) = torch.autograd.grad(out, x, do)
            direct = TA.fused_attention_qkv_bwd(qkv, bias, do, 2, 0.125, out=None, lse=None)
            assert torch.equal(grad, direct)
    out, lse = TA.fused_attention_qkv_fwd(qkv, bias, 2, 0.125, with_lse=True)
    assert lse is None and torch.equal(out, TA.fused_attention_qkv_plain(qkv, bias, 2, 0.125))
    assert (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches) == before


@pytest.mark.parametrize("dtype,W,H,rounds", [
    (torch.bfloat16, 128, 2, True),    # head_dim 64: the mma variant
    (torch.float32, 128, 2, False),    # fp32: the tf32x3 variant, not rounded
    (torch.bfloat16, 80, 2, False),    # head_dim 40: the simt variant
], ids=["bf16_d64", "fp32_d64", "bf16_d40"])
def test_rounded_impl_rounds_where_the_kernel_rounds(dtype, W, H, rounds):
    """impl "rounded" is the plain pair with `mma_rounding` exactly where
    the kernels take their tensor-core variant, and the plain pair as it is
    elsewhere: the bf16 reference of the kernel path."""
    qkv, do, bias = _inputs(2, 33, W, True, seed=W)
    qkv, do = qkv.to(dtype), do.to(dtype)
    x = qkv.clone().requires_grad_(True)
    out = TA.attend(x, bias, H, 0.2, impl="rounded")
    (grad,) = torch.autograd.grad(out, x, do)
    assert torch.equal(out, TA.fused_attention_qkv_plain(qkv, bias, H, 0.2, mma_rounding=rounds))
    assert torch.equal(grad, TA.fused_attention_qkv_bwd_plain(qkv, bias, do, H, 0.2, mma_rounding=rounds))
    plain = TA.attend(qkv, bias, H, 0.2, impl="plain")
    assert torch.equal(out, plain) != rounds
