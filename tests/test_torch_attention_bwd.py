"""The port's attention backward (clip_event_tpu_torch.ops.attention) against
the JAX package: the gradient through the port's `fused_attention_qkv` (its
plain backward on the CPU) vs `jax.vjp` of the Pallas kernel run in
interpret mode, on the same numpy inputs, at fp32 atol 1e-5 (both sides
accumulate in fp32; only the sum order differs). The plain backward also
equals `torch.autograd.grad` through the plain forward, in float64 to
1e-12 and in fp32 to 1e-5. Plus the backward's refusals of what the kernel
cannot take, and per-block recompute (remat) in the transformer stack."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops.attention_pallas import fused_attention_qkv as jax_fused  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402

SHAPES = [(3, 77, 128, 2, True), (2, 50, 192, 3, False), (5, 13, 64, 1, False)]
ATOL = 1e-5


def _inputs(B, S, W, causal, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    do = rng.normal(size=(B, S, W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return qkv, do, bias


@pytest.mark.parametrize("B,S,W,H,causal", SHAPES)
def test_grad_matches_pallas_interpret_vjp(B, S, W, H, causal):
    qkv, do, bias = _inputs(B, S, W, causal)
    scale = (W // H) ** -0.5
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda x: jax_fused(x, jb, H, scale, True), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(do))

    x = torch.from_numpy(qkv).requires_grad_(True)
    tb = None if bias is None else torch.from_numpy(bias)
    out = TA.fused_attention_qkv(x, tb, H, scale)
    (ours,) = torch.autograd.grad(out, x, torch.from_numpy(do))
    assert ours.dtype == torch.float32 and ours.shape == (B, S, 3 * W)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # and the plain backward called directly is the same function
    direct = TA.fused_attention_qkv_bwd(torch.from_numpy(qkv), tb, torch.from_numpy(do), H, scale)
    np.testing.assert_array_equal(direct.numpy(), ours.numpy())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,S,W,H,causal", SHAPES)
def test_plain_bwd_equals_autograd_of_plain_fwd(B, S, W, H, causal, dtype, tol):
    qkv, do, bias = _inputs(B, S, W, causal, seed=1)
    x = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
    g = torch.from_numpy(do).to(dtype)
    tb = None if bias is None else torch.from_numpy(bias).to(dtype)
    scale = (W // H) ** -0.5
    (ref,) = torch.autograd.grad(TA.fused_attention_qkv_plain(x, tb, H, scale), x, g)
    ours = TA.fused_attention_qkv_bwd_plain(x.detach(), tb, g, H, scale)
    assert ours.dtype == dtype
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=tol, rtol=0)


def test_plain_bwd_bf16_keeps_dtype_and_no_bias_grad():
    qkv, do, bias = _inputs(2, 13, 64, True, seed=3)
    x = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    out = TA.attend(x, tb, 2, 0.125, impl="plain")
    dx, db = torch.autograd.grad(out, (x, tb), torch.from_numpy(do).to(torch.bfloat16),
                                 allow_unused=True)
    assert dx.dtype == torch.bfloat16 and db is None
    ref = TA.fused_attention_qkv_bwd_plain(x.detach().float(), tb.detach(),
                                           torch.from_numpy(do).to(torch.bfloat16).float(),
                                           2, 0.125)
    np.testing.assert_allclose(dx.float().numpy(), ref.numpy(), atol=2e-2, rtol=0)


@pytest.mark.parametrize(
    "make_qkv, make_do, match",
    [
        (lambda: torch.empty(2, 13, 192, dtype=torch.float16, device="meta"),
         lambda: torch.empty(2, 13, 64, dtype=torch.float16, device="meta"), "float32 or bfloat16"),
        (lambda: torch.empty(2, 129, 192, device="meta"),
         lambda: torch.empty(2, 129, 64, device="meta"), "S <= 128"),
        (lambda: torch.empty(2, 13, 3 * 258, device="meta"),
         lambda: torch.empty(2, 13, 258, device="meta"), "head_dim <= 128"),
        (lambda: torch.empty(2, 13, 192, device="meta"),
         lambda: torch.empty(2, 13, 64, dtype=torch.bfloat16, device="meta"), "do must be"),
        (lambda: torch.empty(2, 13, 192, device="meta"),
         lambda: torch.empty(2, 12, 64, device="meta"), "do must be"),
        (lambda: torch.empty(2, 13, 192, device="meta"),
         lambda: torch.empty(2, 13, 64, device="meta"), "needs a CUDA tensor"),
    ],
)
def test_bwd_refuses_what_the_kernel_cannot_take(make_qkv, make_do, match):
    """A tensor off the CPU goes to the backward kernel or raises, never to
    the plain version (the meta device stands in for a CUDA tensor)."""
    before = TA.fused_attention_qkv_bwd.launches
    with pytest.raises(ValueError, match=match):
        TA.fused_attention_qkv_bwd(make_qkv(), None, make_do(), 2, 0.125)
    assert TA.fused_attention_qkv_bwd.launches == before


def test_cpu_backward_launches_no_kernel():
    qkv, do, bias = _inputs(2, 13, 64, True)
    x = torch.from_numpy(qkv).requires_grad_(True)
    before = (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches)
    out = TA.fused_attention_qkv(x, torch.from_numpy(bias), 2, 0.125)
    out.backward(torch.from_numpy(do))
    assert (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches) == before
    with pytest.raises(ValueError, match="attention impl"):
        TA.attend(x, None, 2, 0.125, impl="xla")


def _stack(rng, L, W):
    def n(*shape, s=0.05):
        return torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))

    return {
        "attn": {"qkv_w": n(L, W, 3 * W), "qkv_b": n(L, 3 * W), "out_w": n(L, W, W),
                 "out_b": n(L, W)},
        "ln_1": {"scale": 1 + n(L, W), "bias": n(L, W)},
        "mlp": {"fc_w": n(L, W, 4 * W), "fc_b": n(L, 4 * W), "proj_w": n(L, 4 * W, W),
                "proj_b": n(L, W)},
        "ln_2": {"scale": 1 + n(L, W), "bias": n(L, W)},
    }


@pytest.mark.parametrize("impl", TL.IMPLS)
def test_remat_gives_the_same_gradients(impl):
    """Full per-block recompute (torch.utils.checkpoint) changes memory,
    not math: output and every gradient equal the saved-activation run."""
    rng = np.random.default_rng(4)
    params = _stack(rng, 2, 64)
    leaves = [p.requires_grad_(True) for p in
              (params["attn"]["qkv_w"], params["mlp"]["fc_w"], params["ln_1"]["scale"])]
    x = torch.from_numpy(rng.normal(size=(3, 13, 64)).astype(np.float32)).requires_grad_(True)
    bias = TL.causal_mask(13, device="cpu")
    runs = []
    for remat in (False, True, "full"):
        out = TL.transformer(x, params, 2, bias, impl=impl, remat=remat)
        grads = torch.autograd.grad(out.square().sum(), [x, *leaves])
        runs.append((out.detach(), grads))
    for out, grads in runs[1:]:
        np.testing.assert_array_equal(out.numpy(), runs[0][0].numpy())
        for a, b in zip(grads, runs[0][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("policy", ["attn", "dots", "dots_nobatch"])
def test_unported_remat_policies_raise(policy):
    x = torch.zeros(1, 3, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TL.transformer(x, _stack(np.random.default_rng(0), 1, 64), 1, remat=policy)
    with pytest.raises(ValueError, match="remat mode"):
        TL.transformer(x, _stack(np.random.default_rng(0), 1, 64), 1, remat="everything")
