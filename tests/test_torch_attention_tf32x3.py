"""K2's fp32 tensor-core variant, "tf32x3" (split TF32), on the CPU: the
kernels run on the card only (`chip_smoke.py --only k2` and
`tests/test_torch_card.py` hold them there); here:

(a) `tf32_round`, the rounding of `cvt.rna.tf32.f32`, on hand-made bit
    patterns: ties away from zero, zeros, denormals, a value that rounds
    up a binade, infinities and NaN; `tf32_split`'s halves;
(b) the plain version that splits where the kernel splits
    (`tf32x3=True`), forward and gradient, against the JAX head-grid
    Pallas kernel in interpret mode at 1e-5, on numpy-seeded inputs, at
    the head dims the variant takes (16, 32, 64, 128), S = 257 and 197
    (the ViT-L/14 and ViT-B/16 vision towers), S = 150, 129 and 65, with
    and without the causal bias; and within the card's fp32 gates of the
    unsplit plain version: the design is inside them before the card runs;
(c) the three-way rule of `headgrid_variant`, which K1 takes too, for
    every head dim;
(d) the wrapper refuses an fp32 qkv (or do) that is not 16-byte aligned on
    the tf32x3 variant, K2's and K1's;
(e) `library_variant` decodes the libraries' codes 0 / 1 / 2."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops.attention_pallas import (  # noqa: E402
    fused_attention_qkv_headgrid as jax_headgrid,
)
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402

ATOL = 1e-5
# the card's fp32 gates (PERF.md §2): forward max abs, backward relative to
# max|plain|
FWD_GATE, BWD_GATE = 1e-5, 1e-5


def _bits(*words):
    return torch.tensor([w - (1 << 32) if w >= 1 << 31 else w for w in words],
                        dtype=torch.int32).view(torch.float32)


def _words(t):
    return [w & 0xFFFFFFFF for w in t.view(torch.int32).tolist()]


# (fp32 bit patterns in, tf32 bit patterns out): tf32 keeps the top 19 bits
# (sign, 8 exponent bits, 10 mantissa bits); the 13 bits below are cut at
# 0x1000, half of one tf32 ulp
ROUNDING = {
    "tie_away_from_zero": ([0x3F801000, 0xBF801000, 0x3F803000], [0x3F802000, 0xBF802000, 0x3F804000]),
    "below_and_above_a_tie": ([0x3F800FFF, 0x3F801001, 0xBF800FFF], [0x3F800000, 0x3F802000, 0xBF800000]),
    "zeros": ([0x00000000, 0x80000000], [0x00000000, 0x80000000]),
    "denormals": ([0x00000FFF, 0x00001000, 0x8000F123, 0x00116C2E], [0x00000000, 0x00002000, 0x80010000, 0x00116000]),
    "rounds_up_a_binade": ([0x3FFFF000, 0x7F7FF000, 0xC07FFFFF], [0x40000000, 0x7F800000, 0xC0800000]),
    "inf_and_nan_pass": ([0x7F800000, 0xFF800000, 0x7FC00000], [0x7F800000, 0xFF800000, 0x7FC00000]),
}


@pytest.mark.parametrize("case", list(ROUNDING))
def test_tf32_round_on_bit_patterns(case):
    words, want = ROUNDING[case]
    got = TA.tf32_round(_bits(*words))
    assert _words(got) == want
    assert all(w & 0x1FFF == 0 for w in _words(got) if (w & 0x7F800000) != 0x7F800000)


def test_tf32_round_takes_float32_only():
    with pytest.raises(ValueError, match="float32"):
        TA.tf32_round(torch.zeros(3, dtype=torch.float64))


def test_tf32_split_halves():
    """hi and lo are TF32 values, hi + lo is x to 2^-22 of |x| (what the
    variant's products drop), and x − hi is exact."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32) * 37)
    hi, lo = TA.tf32_split(x)
    assert all(w & 0x1FFF == 0 for w in _words(hi) + _words(lo))
    assert torch.equal(TA.tf32_round(hi), hi)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())
    assert torch.equal((x - hi).double(), x.double() - hi.double())


def _inputs(B, S, W, causal, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    do = rng.normal(size=(B, S, W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return qkv, do, bias


# (S, W, H, causal): the path shapes at one head group (D = 64), then the
# other head dims the variant takes and the tile edges of S
SHAPES = [
    (257, 128, 2, False), (197, 128, 2, False), (150, 128, 4, True), (150, 256, 2, False),
    (65, 128, 8, True), (129, 128, 2, True),
]
IDS = [f"S{S}_D{W // H}_{'causal' if c else 'nobias'}" for S, W, H, c in SHAPES]


@pytest.mark.parametrize("S,W,H,causal", SHAPES, ids=IDS)
def test_split_plain_version_matches_pallas_interpret(S, W, H, causal):
    qkv, do, bias = _inputs(1, S, W, causal, seed=S + W // H)
    scale = (W // H) ** -0.5
    jb = None if bias is None else jnp.asarray(bias)
    ref, vjp = jax.vjp(lambda x: jax_headgrid(x, jb, H, scale, True), jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(do))
    tq, tdo = torch.from_numpy(qkv), torch.from_numpy(do)
    tb = None if bias is None else torch.from_numpy(bias)
    out = TA.fused_attention_qkv_plain(tq, tb, H, scale, tf32x3=True)
    grad = TA.fused_attention_qkv_bwd_plain(tq, tb, tdo, H, scale, tf32x3=True)
    assert out.dtype == grad.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=ATOL, rtol=0)
    # the card's gates against the unsplit plain version hold for the split
    # arithmetic itself
    plain = TA.fused_attention_qkv_plain(tq, tb, H, scale)
    assert (out - plain).abs().max().item() <= FWD_GATE
    plain = TA.fused_attention_qkv_bwd_plain(tq, tb, tdo, H, scale)
    assert ((grad - plain).abs().max() / plain.abs().max()).item() <= BWD_GATE
    # and the split is real: one TF32 rounding of the inputs is far outside
    coarse = TA.fused_attention_qkv_plain(TA.tf32_round(tq), tb, H, scale)
    assert (coarse - TA.fused_attention_qkv_plain(tq, tb, H, scale)).abs().max().item() > 10 * FWD_GATE


def test_split_and_mma_rounding_are_exclusive():
    qkv, do, _ = _inputs(1, 5, 128, False, 0)
    qkv, do = torch.from_numpy(qkv), torch.from_numpy(do)
    with pytest.raises(ValueError, match="pick one"):
        TA.fused_attention_qkv_plain(qkv, None, 2, 0.125, mma_rounding=True, tf32x3=True)
    with pytest.raises(ValueError, match="pick one"):
        TA.fused_attention_qkv_bwd_plain(qkv, None, do, 2, 0.125, mma_rounding=True, tf32x3=True)


def test_headgrid_variant_is_three_way():
    for D in TA.MMA_HEAD_DIMS:
        assert TA.headgrid_variant(torch.bfloat16, D) == "mma"
        assert TA.headgrid_variant(torch.float32, D) == "tf32x3"
    for D in (1, 2, 4, 8):  # every other head dim K2 takes (dividing 128)
        assert TA.headgrid_variant(torch.float32, D) == "simt"
        assert TA.headgrid_variant(torch.bfloat16, D) == "simt"
    assert TA.VARIANTS == ("mma", "tf32x3", "simt")
    assert {TA.headgrid_variant(dt, D) for dt in (torch.float32, torch.bfloat16)
            for D in range(1, TA.MAX_HEAD_DIM + 1)} == set(TA.VARIANTS)


def test_k1_keeps_its_two_way_rule_for_every_head_dim():
    # K1's rule is K2's three-way rule now (its fp32 tensor-core variant,
    # "tf32x3"); the name is kept from the two-way rule it pinned before
    for D in range(1, TA.MAX_HEAD_DIM + 1):
        assert TA.k1_variant(torch.float32, D) == ("tf32x3" if D in TA.MMA_HEAD_DIMS else "simt")
        assert TA.k1_variant(torch.bfloat16, D) == ("mma" if D in TA.MMA_HEAD_DIMS else "simt")
    assert TA.VARIANTS == ("mma", "tf32x3", "simt")


def _misaligned(shape):
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=torch.float32)[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("which", ["qkv", "do"])
def test_tf32x3_refuses_a_misaligned_tensor(which):
    B, S, W, H = 1, 130, 128, 2  # head_dim 64
    qkv, do = torch.zeros((B, S, 3 * W)), torch.zeros((B, S, W))
    if which == "qkv":
        qkv = _misaligned((B, S, 3 * W))
    else:
        do = _misaligned((B, S, W))
    with pytest.raises(ValueError, match=f"tf32x3 variant\\) needs {which} aligned to 16 bytes"):
        TA._check_kernel_input(qkv, None, H, do, head_grid=True)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv.clone(), None, H, do.clone(), head_grid=True)
    # K1 takes fp32 at head_dim 64 on its tf32x3 variant too: refused alike
    with pytest.raises(ValueError, match="tf32x3 variant\\) needs qkv aligned to 16 bytes"):
        TA._check_kernel_input(_misaligned((B, 77, 3 * W)), None, H, head_grid=False)


class _StubVariant:
    """A library's variant symbol: returns `code` for any input and takes
    ctypes' argtypes / restype."""

    def __init__(self, code):
        self.code, self.calls = code, []

    def __call__(self, dtype, head_dim):
        self.calls.append((dtype, head_dim))
        return self.code


class _StubLibrary:
    def __init__(self, code):
        self.clip_attention_variant = _StubVariant(code)
        self.clip_attention_hg_variant = _StubVariant(code)


@pytest.mark.parametrize("code,variant", [(0, "simt"), (1, "mma"), (2, "tf32x3")])
def test_library_variant_decodes_every_code(monkeypatch, code, variant):
    lib = _StubLibrary(code)
    monkeypatch.setattr(TA._build, "load", lambda name: lib)
    for name in (TA.HG_KERNEL, TA.HG_BWD_KERNEL, TA.KERNEL, TA.BWD_KERNEL):
        assert TA.library_variant(name, torch.float32, 64) == variant
    # K2's symbol for K2's libraries, K1's for K1's; dtype 0 is fp32
    assert lib.clip_attention_hg_variant.calls == [(0, 64)] * 2
    assert lib.clip_attention_variant.calls == [(0, 64)] * 2


def test_library_variant_refuses_an_unknown_code(monkeypatch):
    monkeypatch.setattr(TA._build, "load", lambda name: _StubLibrary(3))
    with pytest.raises(RuntimeError, match="returned 3"):
        TA.library_variant(TA.HG_KERNEL, torch.bfloat16, 64)
