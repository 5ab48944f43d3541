"""The port's head-grid attention (K2, `fused_attention_qkv_headgrid`, its
plain versions on the CPU) against the JAX package's head-grid Pallas
kernel run in interpret mode, forward and gradient, on the same numpy
inputs at fp32 atol 1e-5 (both sides accumulate in fp32; only the sum
order differs). Plus `head_grid_supported` against JAX's, the dispatch of
`multi_head_attention` (K1 up to S = 128, K2 beyond, a ValueError where
neither kernel takes the shape), a ViT tower whose vision sequence is
longer than 128 going through K2 and matching JAX's `encode_image` at
1e-4, and the wrapper's refusals of what the kernel cannot take."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.ops.attention_pallas import (  # noqa: E402
    fused_attention_qkv_headgrid as jax_headgrid,
)
from clip_event_tpu.ops.attention_pallas import head_grid_supported as jax_supported  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402

SHAPES = [(2, 13, 128, 2), (2, 150, 256, 8), (1, 257, 128, 2)]  # B, S, W, H
ATOL = 1e-5


def _inputs(B, S, W, causal, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    do = rng.normal(size=(B, S, W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return qkv, do, bias


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,W,H", SHAPES)
def test_forward_and_grad_match_pallas_interpret(B, S, W, H, causal):
    qkv, do, bias = _inputs(B, S, W, causal)
    scale = (W // H) ** -0.5
    jb = None if bias is None else jnp.asarray(bias)
    ref, vjp = jax.vjp(lambda x: jax_headgrid(x, jb, H, scale, True), jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(do))

    x = torch.from_numpy(qkv).requires_grad_(True)
    tb = None if bias is None else torch.from_numpy(bias)
    out = TA.fused_attention_qkv_headgrid(x, tb, H, scale)
    assert out.dtype == torch.float32 and out.shape == (B, S, W)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(do))
    assert grad.shape == (B, S, 3 * W)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=ATOL, rtol=0)
    # the backward called directly is the same function
    direct = TA.fused_attention_qkv_headgrid_bwd(torch.from_numpy(qkv), tb, torch.from_numpy(do),
                                                 H, scale)
    np.testing.assert_array_equal(direct.numpy(), grad.numpy())


@pytest.mark.parametrize("S,W,H", [(257, 1024, 16), (197, 768, 12), (197, 192, 3), (150, 384, 4),
                                   (77, 512, 8), (5, 256, 1)])
def test_head_grid_supported_matches_jax(S, W, H):
    assert TA.head_grid_supported(S, W, H) == jax_supported(S, W, H)


def test_head_grid_supported_on_the_presets():
    assert TA.head_grid_supported(257, 1024, 16) and TA.head_grid_supported(197, 768, 12)
    assert not TA.head_grid_supported(197, 192, 3)  # W % 128 != 0
    assert not TA.head_grid_supported(197, 384, 4)  # head_dim 96 does not divide 128


def _count(monkeypatch, name):
    calls = []
    orig = getattr(TA, name)

    def counting(qkv, bias, num_heads, scale):
        calls.append(tuple(qkv.shape))
        return orig(qkv, bias, num_heads, scale)

    monkeypatch.setattr(TA, name, counting)
    return calls


def test_dispatch_by_shape(monkeypatch):
    """S <= 128 → K1; S > 128 with a head-grid shape → K2; neither → a
    ValueError naming the shape, on the CPU as on the card; "plain" runs
    every shape."""
    k1, k2 = _count(monkeypatch, "fused_attention_qkv"), _count(monkeypatch, "fused_attention_qkv_headgrid")
    rng = np.random.default_rng(1)
    for S in (128, 129):
        qkv = torch.from_numpy(rng.normal(size=(2, S, 3 * 128)).astype(np.float32))
        out = TL.attention_core(qkv, None, 2, 0.125)
        np.testing.assert_allclose(
            out.numpy(), TL.attention_core(qkv, None, 2, 0.125, impl="plain").numpy(), atol=1e-6)
    assert k1 == [(2, 128, 384)] and k2 == [(2, 129, 384)]
    bad = torch.from_numpy(rng.normal(size=(2, 150, 3 * 192)).astype(np.float32))
    with pytest.raises(ValueError, match=r"no attention kernel takes S=150, W=192, H=3"):
        TL.attention_core(bad, None, 3, 0.125)
    assert TL.attention_core(bad, None, 3, 0.125, impl="plain").shape == (2, 150, 192)
    with pytest.raises(ValueError, match="attention impl"):
        TL.attention_core(bad, None, 3, 0.125, impl="xla")


VIT = dict(
    embed_dim=64, image_resolution=48, vision_layers=2, vision_width=128,
    vision_patch_size=4, context_length=77, vocab_size=512,
    transformer_width=64, transformer_heads=2, transformer_layers=1,
)


def test_vit_longer_than_128_runs_through_k2(monkeypatch):
    """Grid 12 → S = 145 vision tokens, W = 128, 2 heads: every block takes
    the K2 entry point, and the features match JAX's einsum path."""
    jcfg, tcfg = J.CLIPConfig(**VIT), T.CLIPConfig(**VIT)
    assert tcfg.grid_size ** 2 + 1 == 145
    np_params = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(np_params, tcfg, device="cpu")
    images = np.random.default_rng(2).integers(0, 256, size=(2, 48, 48, 3), dtype=np.uint8)
    k1, k2 = _count(monkeypatch, "fused_attention_qkv"), _count(monkeypatch, "fused_attention_qkv_headgrid")
    ours = T.encode_image(params, tcfg, torch.from_numpy(images))
    assert k2 == [(2, 145, 384)] * 2 and k1 == []
    ref = np.asarray(J.encode_image(jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(images)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
    grid = T.encode_image(params, tcfg, torch.from_numpy(images), use_grid=True)
    jgrid = np.asarray(J.encode_image(jax.tree.map(jnp.asarray, np_params), jcfg,
                                      jnp.asarray(images), use_grid=True))
    assert grid.shape == (2, 145, 64)
    np.testing.assert_allclose(grid.numpy(), jgrid, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "make_qkv, make_do, match",
    [
        (lambda: torch.empty(2, 197, 3 * 192, device="meta"), None, "head-grid attention kernel"),
        (lambda: torch.empty(2, 197, 3 * 384, device="meta"), None, "head_dim dividing 128"),
        (lambda: torch.empty(2, 197, 384, dtype=torch.float16, device="meta"), None,
         "float32 or bfloat16"),
        (lambda: torch.empty(2, 197, 384, device="meta"), None, "needs a CUDA tensor"),
        (lambda: torch.empty(2, 197, 384, device="meta"),
         lambda: torch.empty(2, 197, 128, dtype=torch.bfloat16, device="meta"), "do must be"),
    ],
)
def test_refuses_what_the_kernel_cannot_take(make_qkv, make_do, match):
    """A tensor off the CPU goes to K2 or raises, never to the plain version
    (the meta device stands in for a CUDA tensor)."""
    before = (TA.fused_attention_qkv_headgrid.launches, TA.fused_attention_qkv_headgrid_bwd.launches)
    with pytest.raises(ValueError, match=match):
        if make_do is None:
            TA.fused_attention_qkv_headgrid(make_qkv(), None, 2, 0.125)
        else:
            TA.fused_attention_qkv_headgrid_bwd(make_qkv(), None, make_do(), 2, 0.125)
    after = (TA.fused_attention_qkv_headgrid.launches, TA.fused_attention_qkv_headgrid_bwd.launches)
    assert after == before


def test_cpu_runs_launch_no_kernel():
    qkv, do, bias = _inputs(2, 140, 128, True)
    x = torch.from_numpy(qkv).requires_grad_(True)
    before = (TA.fused_attention_qkv_headgrid.launches, TA.fused_attention_qkv_headgrid_bwd.launches)
    TA.fused_attention_qkv_headgrid(x, torch.from_numpy(bias), 2, 0.125).backward(torch.from_numpy(do))
    after = (TA.fused_attention_qkv_headgrid.launches, TA.fused_attention_qkv_headgrid_bwd.launches)
    assert after == before and x.grad is not None
