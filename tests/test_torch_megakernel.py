"""The port's LayerNorm → QKV → attention megakernel (K6,
clip_event_tpu_torch.ops.attention.fused_ln_qkv_attention) against the JAX
package on the CPU: the same numpy inputs go through the JAX Pallas kernel
in interpret mode and through the port's plain version (what the wrapper
runs on a CPU tensor).

Tolerances: fp32 1e-4 (the two sides sum the projection in another order);
bf16 2e-2 max and 1e-5 mean abs error (measured 2e-3 and 1e-7: a rare
one-ulp flip), which holds only with the kernel's
roundings: γ, β, the weight and its bias cast to bf16 first, the LayerNorm
rounded to bf16 before the product, the product accumulated and kept in
fp32 up to the attention core (a plain version that rounds the projection
to bf16, as `torch.matmul` of bf16 operands does, is shown to miss it)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops.attention_pallas import fused_ln_qkv_attention as jax_mega  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402

SHAPES = [(3, 77, 128, 2, True), (2, 50, 192, 3, False)]
IDS = ["text_causal", "vision"]


def _inputs(B, S, W, causal, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=W)).astype(np.float32)
    beta = (0.1 * rng.normal(size=W)).astype(np.float32)
    w = (rng.normal(size=(W, 3 * W)) * W ** -0.5).astype(np.float32)
    wb = (0.1 * rng.normal(size=3 * W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return x, gamma, beta, w, wb, bias


def _jax(x, gamma, beta, w, wb, bias, H, dtype):
    jb = None if bias is None else jnp.asarray(bias)
    out = jax_mega(jnp.asarray(x).astype(dtype), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
                   jnp.asarray(wb), jb, H, (x.shape[-1] // H) ** -0.5, interpret=True)
    return np.asarray(out, np.float32)


def _torch_args(x, gamma, beta, w, wb, bias, H, dtype):
    tb = None if bias is None else torch.from_numpy(bias)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(gamma), torch.from_numpy(beta),
            torch.from_numpy(w), torch.from_numpy(wb), tb, H, (x.shape[-1] // H) ** -0.5)


@pytest.mark.parametrize("B,S,W,H,causal", SHAPES, ids=IDS)
def test_plain_matches_jax_kernel_fp32(B, S, W, H, causal):
    inputs = _inputs(B, S, W, causal)
    ref = _jax(*inputs, H, jnp.float32)
    args = _torch_args(*inputs, H, torch.float32)
    ours = TA.fused_ln_qkv_attention_plain(*args)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (B, S, W)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(TA.fused_ln_qkv_attention(*args), ours)


@pytest.mark.parametrize("B,S,W,H,causal", SHAPES, ids=IDS)
def test_plain_matches_jax_kernel_bf16_roundings(B, S, W, H, causal):
    inputs = _inputs(B, S, W, causal, seed=1)
    ref = _jax(*inputs, H, jnp.bfloat16)
    args = _torch_args(*inputs, H, torch.bfloat16)
    ours = TA.fused_ln_qkv_attention_plain(*args)
    assert ours.dtype == torch.bfloat16
    err = np.abs(ours.float().numpy() - ref)
    assert err.max() <= 2e-2 and err.mean() <= 1e-5, (err.max(), err.mean())

    # the same chain with the projection rounded to bf16 (a bf16 matmul) is
    # far from the kernel (mean ~8e-4): the plain version must not do it
    x, gamma, beta, w, wb, bias, _, scale = args
    ln = TL.layer_norm(x, {"scale": gamma.bfloat16(), "bias": beta.bfloat16()})
    qkv = torch.matmul(ln, w.bfloat16()) + wb.bfloat16()
    rounded = TA.fused_attention_qkv_plain(qkv, bias, H, scale).float().numpy()
    assert np.abs(rounded - ref).mean() > 1e-4


def test_unfused_chain_agrees_in_fp32():
    """Plain LayerNorm → `linear` → the attention core, what the component
    bench times the megakernel against."""
    inputs = _inputs(2, 19, 64, True, seed=2)
    x, gamma, beta, w, wb, bias, H, scale = _torch_args(*inputs, 2, torch.float32)
    fused = TA.fused_ln_qkv_attention(x, gamma, beta, w, wb, bias, H, scale)
    qkv = TL.linear(TL.layer_norm(x, {"scale": gamma, "bias": beta}), w, wb)
    chain = TA.fused_attention_qkv(qkv, bias, H, scale)
    np.testing.assert_allclose(fused.numpy(), chain.numpy(), atol=1e-5, rtol=0)


def test_no_bias_means_no_mask():
    inputs = _inputs(2, 9, 64, False, seed=3)
    args = list(_torch_args(*inputs, 2, torch.float32))
    none = TA.fused_ln_qkv_attention(*args)
    args[5] = torch.zeros(9, 9)
    np.testing.assert_allclose(none.numpy(), TA.fused_ln_qkv_attention(*args).numpy(), atol=1e-7, rtol=0)


def test_forward_only_and_counter():
    """No gradient flows through K6: where autograd records, the result
    does not require grad. On the CPU nothing is launched."""
    inputs = _inputs(2, 9, 64, True, seed=4)
    args = list(_torch_args(*inputs, 2, torch.float32))
    args[0].requires_grad_(True)
    args[3].requires_grad_(True)
    before = TA.fused_ln_qkv_attention.launches
    out = TA.fused_ln_qkv_attention(*args)
    assert not out.requires_grad and out.grad_fn is None
    assert TA.fused_ln_qkv_attention.launches == before
    with pytest.raises(ValueError, match="not divisible"):
        TA.fused_ln_qkv_attention(args[0], *args[1:6], 5, 1.0)


def test_megakernel_supported_states_the_kernel_limits():
    assert TA.megakernel_supported(77, 512, 8) and TA.megakernel_supported(50, 768, 12)
    assert TA.megakernel_supported(128, 128, 2) and TA.megakernel_supported(1, 60, 3)
    assert TA.megakernel_supported(77, 1280, 20)  # any width with such heads
    assert not TA.megakernel_supported(129, 512, 8)  # S > 128
    assert not TA.megakernel_supported(197, 768, 12) and not TA.megakernel_supported(257, 1024, 16)
    assert not TA.megakernel_supported(77, 256, 2)  # head_dim 128 > 64
    assert not TA.megakernel_supported(77, 132, 6)  # head_dim 22: not a multiple of 4
    assert not TA.megakernel_supported(77, 100, 3) and not TA.megakernel_supported(0, 64, 1)
    # a shape the kernel refuses still runs through the plain version
    inputs = _inputs(1, 130, 64, False, seed=5)
    out = TA.fused_ln_qkv_attention_plain(*_torch_args(*inputs, 1, torch.float32))
    assert tuple(out.shape) == (1, 130, 64)
