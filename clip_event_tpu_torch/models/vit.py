"""Vision Transformer tower (counterpart of `clip_event_tpu/models/vit.py`).

The strided patch convolution is a reshape plus one matmul (identical for
stride == kernel). Input layout is NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch

from clip_event_tpu_torch.models import layers as L


def patch_embed(images: torch.Tensor, w: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, grid², width] via non-overlapping patch matmul.

    `w` is [patch*patch*3, width], flattened in (kh, kw, C) order."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, patch * patch * C)
    return L.linear(x, w)


def vit_encode(
    params: dict,
    images: torch.Tensor,
    patch_size: int,
    num_heads: int,
    use_grid: bool = False,
    compute_dtype=torch.float32,
    impl: str = "kernel",
    remat=False,
) -> torch.Tensor:
    """ViT forward. Returns [B, E] (CLS-pooled) or [B, grid²+1, E] if use_grid."""
    x = patch_embed(images.to(compute_dtype), params["patch_embed_w"], patch_size)
    B, _, W = x.shape
    cls = params["class_embedding"].to(x.dtype).expand(B, 1, W)
    x = torch.cat([cls, x], dim=1)  # [B, G²+1, W]
    x = x + params["positional_embedding"].to(x.dtype)
    x = L.layer_norm(x, params["ln_pre"])
    x = L.transformer(x, params["transformer"], num_heads, impl=impl, remat=remat)
    if use_grid:
        x = L.layer_norm(x, params["ln_post"])  # all tokens (grid path)
    else:
        x = L.layer_norm(x[:, 0, :], params["ln_post"])  # CLS only
    return L.linear(x, params["proj"])


def init_vit(
    gen: torch.Generator,
    input_resolution: int,
    patch_size: int,
    width: int,
    num_layers: int,
    output_dim: int,
) -> dict:
    grid = input_resolution // patch_size
    scale = width**-0.5

    def normal(*shape):
        return scale * torch.randn(shape, generator=gen)

    return {
        "patch_embed_w": normal(patch_size * patch_size * 3, width),
        "class_embedding": normal(width),
        "positional_embedding": normal(grid * grid + 1, width),
        "ln_pre": L.init_layer_norm(width),
        "transformer": L.init_transformer(gen, num_layers, width),
        "ln_post": L.init_layer_norm(width),
        "proj": normal(width, output_dim),
    }
