"""Building blocks shared by the vision and text towers, as plain functions
on tensors (counterpart of `clip_event_tpu/models/layers.py`).

Params are nested dicts of tensors with the JAX package's names and
layouts: dense weights input-major `[in, out]`, transformer layers stacked
along a leading `[L, ...]` axis. LayerNorm always runs in float32 (the fp32
island); matmuls run in the activations' dtype.

`impl` selects the attention core: "kernel" (the default) calls
`ops.attention.fused_attention_qkv` (K1) where S <= 128, else
`fused_attention_qkv_headgrid` (K2) where `head_grid_supported`, else
raises; each launches its hand-written kernels (forward and backward) on a
CUDA tensor and runs their plain versions on a CPU tensor. "plain" runs
those plain versions on any device, the reference a run on the card is
held against. In fp32 both equal the JAX package's einsum path; in bf16
they keep the probabilities in fp32 as its kernel path does, where its
einsum path rounds them to bf16 before P·V.

`remat` (the JAX package's `transformer(..., remat=)`): True or "full"
recomputes each block in the backward pass (`torch.utils.checkpoint`, the
counterpart of `jax.checkpoint(..., nothing_saveable)`); False saves every
activation. The selective policies of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from clip_event_tpu_torch.ops import attention as A
from clip_event_tpu_torch.ops.attention import IMPLS

# the JAX package's selective remat policies (`layers.py:470-475`)
_UNPORTED_REMAT = ("attn", "dots", "dots_nobatch")


def layer_norm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32, cast back."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b), weights input-major `[in, out]`, cast to x's dtype."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def multi_head_attention(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    attn_bias: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Self-attention with packed QKV projection.

    x: [B, S, W]; params: qkv_w [W, 3W], qkv_b [3W], out_w [W, W], out_b [W].
    attn_bias: optional additive [S, S] mask (e.g. causal -inf upper triangle).
    """
    scale = (x.shape[-1] // num_heads) ** -0.5
    qkv = linear(x, params["qkv_w"], params["qkv_b"])  # [B, S, 3W]
    out = attention_core(qkv, attn_bias, num_heads, scale, impl)
    return linear(out, params["out_w"], params["out_b"])


def attention_core(
    qkv: torch.Tensor,
    attn_bias: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
    impl: str = "kernel",
) -> torch.Tensor:
    """The attention core over the packed projection, chosen by shape alone
    before anything launches (JAX `layers.py:285-311`): K1 where S <= 128
    and head_dim <= 128, else K2 where `head_grid_supported`, else a
    ValueError naming the shape. The JAX package sends that last case to its
    einsum path; here it raises on every device, so a CPU run shows what a
    card run would do. No CLIP preset reaches it. `impl="plain"` runs the
    plain versions at any shape."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; options: {IMPLS}")
    if impl == "plain":
        return A.attend(qkv, attn_bias, num_heads, scale, "plain")
    B, S, W3 = qkv.shape
    W = W3 // 3
    if S <= A.MAX_SEQ and W // num_heads <= A.MAX_HEAD_DIM:
        return A.fused_attention_qkv(qkv, attn_bias, num_heads, scale)
    if A.head_grid_supported(S, W, num_heads):
        return A.fused_attention_qkv_headgrid(qkv, attn_bias, num_heads, scale)
    raise ValueError(
        f"no attention kernel takes S={S}, W={W}, H={num_heads}: K1 needs S <= {A.MAX_SEQ} "
        f"and head_dim <= {A.MAX_HEAD_DIM}; K2 needs W % {A.HG_LANES} == 0 and head_dim "
        f"dividing {A.HG_LANES} (impl='plain' runs any shape)"
    )


def residual_block(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    attn_bias: Optional[torch.Tensor] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Pre-LN transformer block: MHA + QuickGELU MLP, both residual."""
    x = x + multi_head_attention(
        layer_norm(x, params["ln_1"]), params["attn"], num_heads, attn_bias, impl
    )
    h = layer_norm(x, params["ln_2"])
    h = quick_gelu(linear(h, params["mlp"]["fc_w"], params["mlp"]["fc_b"]))
    return x + linear(h, params["mlp"]["proj_w"], params["mlp"]["proj_b"])


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _remat_enabled(remat) -> bool:
    """False for no remat, True for full per-block recompute; raises for the
    JAX package's selective policies, which are not ported yet."""
    if remat in (False, None, 0):
        return False
    if remat is True or remat == "full":
        return True
    if remat in _UNPORTED_REMAT:
        raise NotImplementedError(
            f"remat policy {remat!r} is not ported yet (ROADMAP A2): use true/'full' or false"
        )
    raise ValueError(f"remat mode {remat!r}; options: True, 'full', False")


def transformer(
    x: torch.Tensor,
    stacked_params: dict,
    num_heads: int,
    attn_bias: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    remat=False,
) -> torch.Tensor:
    """Run the stack of residual blocks over the leading L axis of the params,
    each block recomputed in the backward pass when `remat` is on and
    autograd is recording."""
    recompute = _remat_enabled(remat) and torch.is_grad_enabled()
    n_layers = stacked_params["attn"]["qkv_w"].shape[0]
    for i in range(n_layers):
        args = (x, _layer(stacked_params, i), num_heads, attn_bias, impl)
        x = checkpoint(residual_block, *args, use_reentrant=False) if recompute else residual_block(*args)
    return x


def causal_mask(seq_len: int, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask: 0 on/below diagonal, -inf above."""
    full = torch.full((seq_len, seq_len), float("-inf"), dtype=dtype, device=device)
    return torch.triu(full, diagonal=1)


# ------------------------------------------------------------------ init


def init_layer_norm(width: int, layers: Optional[int] = None) -> dict:
    shape = (width,) if layers is None else (layers, width)
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def init_transformer(gen: torch.Generator, layers: int, width: int) -> dict:
    """The JAX package's init scheme (reference `model_clip.py:365-372`),
    stacked along L, drawn on the CPU from `gen`."""
    proj_std = (width**-0.5) * ((2 * layers) ** -0.5)
    attn_std = width**-0.5
    fc_std = (2 * width) ** -0.5

    def normal(std, *shape):
        return std * torch.randn(shape, generator=gen)

    return {
        "attn": {
            "qkv_w": normal(attn_std, layers, width, 3 * width),
            "qkv_b": torch.zeros(layers, 3 * width),
            "out_w": normal(proj_std, layers, width, width),
            "out_b": torch.zeros(layers, width),
        },
        "ln_1": init_layer_norm(width, layers),
        "mlp": {
            "fc_w": normal(fc_std, layers, width, 4 * width),
            "fc_b": torch.zeros(layers, 4 * width),
            "proj_w": normal(proj_std, layers, 4 * width, width),
            "proj_b": torch.zeros(layers, width),
        },
        "ln_2": init_layer_norm(width, layers),
    }
