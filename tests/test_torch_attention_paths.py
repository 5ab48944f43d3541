"""K1's and K2's two ways in (clip_event_tpu_torch.ops.attention), on the CPU,
and the host-side rules of their bf16 forwards on Hopper's warpgroup MMA.

Ways in: with grad mode off, or with a qkv that requires no gradient,
`fused_attention_qkv` and `fused_attention_qkv_headgrid` call the forward
directly instead of through `torch.autograd.Function`; the result must be
the same bits as the autograd path's, with the same launch counts, and
both are held against the JAX package's Pallas kernels in interpret mode
(`ops/attention_pallas.py`) at fp32 atol 1e-5 (the numerics
tests/test_torch_attention.py holds the port to).

Rules: the bf16 forwards ("mma") read qkv and write out through TMA tensor
maps, which need the base 16 bytes aligned and each row's pitch (6W bytes
of qkv, 2W of out) a multiple of 16 bytes; the wrapper refuses a
misaligned base before a launch, and every width the variant rule gives
"mma" has such pitches. On the CPU no kernel runs to show either.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops.attention_pallas import fused_attention_qkv as jax_fused  # noqa: E402
from clip_event_tpu.ops.attention_pallas import fused_attention_qkv_headgrid as jax_headgrid  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

ATOL = 1e-5
# (B, S, W, H, causal): K1's (S <= 128) and K2's (W a multiple of 128)
K1_SHAPES = [(3, 77, 128, 2, True), (2, 50, 192, 3, False), (1, 1, 64, 1, False)]
K2_SHAPES = [(2, 129, 128, 2, True), (2, 65, 256, 4, False), (1, 1, 128, 2, False)]
ENTRIES = {"k1": (TA.fused_attention_qkv, jax_fused, K1_SHAPES),
           "k2": (TA.fused_attention_qkv_headgrid, jax_headgrid, K2_SHAPES)}


def _inputs(B, S, W, causal, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return qkv, bias


def _launches():
    return (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_headgrid.launches,
            TA.fused_attention_qkv_bwd.launches, TA.fused_attention_qkv_headgrid_bwd.launches)


@pytest.mark.parametrize("entry,shape", [(e, s) for e, (_, _, shapes) in ENTRIES.items() for s in shapes],
                         ids=str)
def test_no_grad_path_equals_autograd_path_and_jax(entry, shape):
    fn, jax_fn, _ = ENTRIES[entry]
    B, S, W, H, causal = shape
    qkv, bias = _inputs(B, S, W, causal, 31)
    scale = (W // H) ** -0.5
    jb = None if bias is None else jnp.asarray(bias)
    ref = np.asarray(jax_fn(jnp.asarray(qkv), jb, H, scale, True))
    tb = None if bias is None else torch.from_numpy(bias)
    before = _launches()
    leaf = torch.from_numpy(qkv).requires_grad_(True)
    graded = fn(leaf, tb, H, scale)
    assert graded.grad_fn is not None
    with torch.no_grad():
        off = fn(leaf, tb, H, scale)
    # qkv requires no gradient, grad mode on
    plain_in = fn(leaf.detach(), tb, H, scale)
    assert off.grad_fn is None and plain_in.grad_fn is None
    assert torch.equal(off, graded.detach()) and torch.equal(plain_in, graded.detach())
    # the CPU runs the plain version on either path: no launch counted
    assert _launches() == before
    np.testing.assert_allclose(off.numpy(), ref, atol=ATOL, rtol=0)


def test_no_grad_path_skips_the_autograd_function(monkeypatch):
    """Without a gradient to track the public forwards never enter
    `autograd.Function.apply`; with one they do."""
    def refuse(*args):
        raise AssertionError("autograd.Function.apply called")

    monkeypatch.setattr(TA._FusedAttention, "apply", refuse)
    monkeypatch.setattr(TA._HeadGridAttention, "apply", refuse)
    qkv = torch.randn(2, 9, 3 * 128)
    TA.fused_attention_qkv(qkv, None, 2, 0.125)
    TA.fused_attention_qkv_headgrid(qkv, None, 2, 0.125)
    leaf = qkv.clone().requires_grad_(True)
    with torch.no_grad():
        TA.fused_attention_qkv(leaf, None, 2, 0.125)
        TA.fused_attention_qkv_headgrid(leaf, None, 2, 0.125)
    for call in (lambda: TA.fused_attention_qkv(leaf, None, 2, 0.125),
                 lambda: TA.fused_attention_qkv_headgrid(leaf, None, 2, 0.125)):
        with pytest.raises(AssertionError, match="apply called"):
            call()


@pytest.mark.parametrize("head_grid", [False, True], ids=["k1", "k2"])
def test_mma_forward_refuses_a_misaligned_base(head_grid):
    """A contiguous bf16 view one element past a 16-byte boundary is refused
    before anything launches, whichever pair takes it; its clone passes
    every check but the CPU's."""
    B, S, W, H = 2, 65, 256, 4
    flat = torch.zeros(B * S * 3 * W + 1, dtype=torch.bfloat16)
    qkv = flat[1:].view(B, S, 3 * W)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    before = _launches()
    with pytest.raises(ValueError, match="needs qkv aligned to 16 bytes"):
        TA._check_kernel_input(qkv, None, H, head_grid=head_grid)
    with pytest.raises(ValueError, match="needs a CUDA tensor, got cpu"):
        TA._check_kernel_input(qkv.clone(), None, H, head_grid=head_grid)
    assert _launches() == before


@pytest.mark.parametrize("dtype,head_dim,variant", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 128, "mma"), (torch.float32, 64, "tf32x3"), (torch.bfloat16, 8, "simt"),
    (torch.float32, 40, "simt"),
])
@pytest.mark.parametrize("heads", [1, 3, 12])
def test_every_width_the_rule_names_passes_the_checks(dtype, head_dim, variant, heads):
    """Every width a variant takes passes every check of both pairs but the
    last, the CUDA one: at each head_dim the rule sends to "mma", qkv's and
    out's row pitches (6W and 2W bytes) are multiples of the TMA's 16, so
    no width reaches the kernels' tensor-map encode unable to pass it."""
    W = heads * head_dim
    assert TA.headgrid_variant(dtype, head_dim) == variant
    if variant == "mma":
        assert (3 * W * 2) % 16 == 0 and (W * 2) % 16 == 0
    qkv = torch.zeros((2, 9, 3 * W), dtype=dtype)
    for head_grid in (False, True):
        if head_grid and not TA.head_grid_supported(9, W, heads):
            continue
        with pytest.raises(ValueError, match="needs a CUDA tensor, got cpu"):
            TA._check_kernel_input(qkv, None, heads, head_grid=head_grid)
