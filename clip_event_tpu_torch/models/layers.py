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

`ln` selects the LayerNorm of a residual block's two norms (the JAX
package's `transformer(..., ln=)`): "xla" (the default) runs `layer_norm`
in plain PyTorch; "pallas" runs the fused kernels of `ops.ln` (K4:
`fused_layer_norm` for `ln_1`, `fused_add_layer_norm` for the mid-block
residual add + `ln_2`, their shared backward kernel), on the card for a
CUDA tensor and as plain versions for a CPU tensor. `transformer` resolves
None to the process-wide choice of `set_ln_impl` (`use_pallas_ln` in the
train config) and hands it to every block as a plain argument, through
`torch.utils.checkpoint` too. `ln_pre`, `ln_post` and `ln_final` call
`layer_norm` directly, as in the JAX package. The names of the two
settings are the JAX package's.

A dense weight may be an int8 `ops.quant.QuantWeight` (the inference
path): `linear` sends it to `quantized_linear` (K5 on the card), and
`_layer` slices its stacked tensors like any other leaf. `act_stats`, a
dict passed to `multi_head_attention` / `residual_block`, records the
abs-max of every dense input for static int8 calibration.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from clip_event_tpu_torch.ops import attention as A
from clip_event_tpu_torch.ops import ln as LN
from clip_event_tpu_torch.ops.attention import IMPLS
from clip_event_tpu_torch.ops.quant import QuantWeight, quantized_linear

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


LN_IMPLS = ("xla", "pallas")
_LN_IMPL = "xla"


def set_ln_impl(impl: str, mesh=None) -> None:
    """Select the LayerNorm of the transformer blocks for every later
    `transformer` call that passes no `ln`: "xla" (plain PyTorch, the
    default) or "pallas" (the fused kernels of `ops.ln`). The JAX package's
    `mesh` argument (shard_map of the kernels over a multi-chip mesh) waits
    for the multi-device port: only None is accepted."""
    global _LN_IMPL
    if impl not in LN_IMPLS:
        raise ValueError("ln impl must be 'xla' or 'pallas'")
    if mesh is not None:
        raise NotImplementedError("set_ln_impl(mesh=...) is not ported yet (ROADMAP A11)")
    _LN_IMPL = impl


def _resolve_ln() -> str:
    """The process-wide LayerNorm choice (`set_ln_impl`)."""
    return _LN_IMPL


@contextlib.contextmanager
def ln_impl(impl: str):
    """`with ln_impl("pallas"):` selects the LayerNorm of the transformer
    blocks inside (`set_ln_impl`) and puts the previous choice back after,
    so one process can run both settings."""
    old = _resolve_ln()
    set_ln_impl(impl)
    try:
        yield
    finally:
        set_ln_impl(old)


def _block_ln_plan(ln: str, act_stats: Optional[dict]) -> str:
    """The LayerNorm path of one residual block: "xla" or "pallas". The
    calibration pass (`act_stats` given) runs the plain LayerNorm, as in
    the JAX package. A width the kernels do not take is not sent to the
    plain LayerNorm: `ops.ln` raises on it on every device, where the JAX
    package warns and runs its XLA LayerNorm, which on this path would hide
    that the kernel did not run."""
    if ln not in LN_IMPLS:
        raise ValueError(f"ln impl {ln!r}; options: {LN_IMPLS}")
    return "xla" if ln != "pallas" or act_stats is not None else "pallas"


def _ln_apply(x: torch.Tensor, p: dict, plan: str) -> torch.Tensor:
    """LayerNorm by a `_block_ln_plan` decision."""
    if plan == "xla":
        return layer_norm(x, p)
    return LN.fused_layer_norm(x, p["scale"], p["bias"])


def _add_ln_apply(res: torch.Tensor, delta: torch.Tensor, p: dict, plan: str):
    """(res + delta, LayerNorm(res + delta)) by a `_block_ln_plan` decision:
    the fused kernel folds the residual add into the LayerNorm's one read."""
    if plan == "xla":
        x = res + delta
        return x, layer_norm(x, p)
    return LN.fused_add_layer_norm(res, delta, p["scale"], p["bias"])


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b), weights input-major `[in, out]`, cast to x's dtype;
    an int8 `QuantWeight` goes through `quantized_linear`."""
    if isinstance(w, QuantWeight):
        return quantized_linear(x, w, b)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """Scalar abs-max in fp32 (static int8 activation calibration)."""
    return x.float().abs().amax()


def multi_head_attention(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    attn_bias: Optional[torch.Tensor] = None,
    impl: str = "kernel",
    act_stats: Optional[dict] = None,
) -> torch.Tensor:
    """Self-attention with packed QKV projection.

    x: [B, S, W]; params: qkv_w [W, 3W], qkv_b [3W], out_w [W, W], out_b [W].
    attn_bias: optional additive [S, S] mask (e.g. causal -inf upper triangle).
    """
    scale = (x.shape[-1] // num_heads) ** -0.5
    if act_stats is not None:
        act_stats["qkv_w"] = _absmax(x)
    qkv = linear(x, params["qkv_w"], params["qkv_b"])  # [B, S, 3W]
    out = attention_core(qkv, attn_bias, num_heads, scale, impl)
    if act_stats is not None:
        act_stats["out_w"] = _absmax(out)
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
    act_stats: Optional[dict] = None,
    ln: str = "xla",
) -> torch.Tensor:
    """Pre-LN transformer block: MHA + QuickGELU MLP, both residual.

    `act_stats`: when a dict is passed, the scalar abs-max of every dense
    input is recorded into it, nested as the param tree
    ({"attn": {qkv_w, out_w}, "mlp": {fc_w, proj_w}}).

    `ln`: "xla" or "pallas", the LayerNorm of `ln_1` and of the mid-block
    residual add + `ln_2` (see the module docstring)."""
    attn_stats = mlp_stats = None
    if act_stats is not None:
        attn_stats = act_stats["attn"] = {}
        mlp_stats = act_stats["mlp"] = {}
    ln_plan = _block_ln_plan(ln, act_stats)
    a = multi_head_attention(
        _ln_apply(x, params["ln_1"], ln_plan), params["attn"], num_heads, attn_bias, impl, attn_stats
    )
    x, h = _add_ln_apply(x, a, params["ln_2"], ln_plan)
    if mlp_stats is not None:
        mlp_stats["fc_w"] = _absmax(h)
    h = quick_gelu(linear(h, params["mlp"]["fc_w"], params["mlp"]["fc_b"]))
    if mlp_stats is not None:
        mlp_stats["proj_w"] = _absmax(h)
    return x + linear(h, params["mlp"]["proj_w"], params["mlp"]["proj_b"])


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked param tree; a QuantWeight slices its q, scale
    and act_scale ([L] → one scalar)."""
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
    ln: Optional[str] = None,
) -> torch.Tensor:
    """Run the stack of residual blocks over the leading L axis of the params,
    each block recomputed in the backward pass when `remat` is on and
    autograd is recording. `ln` None takes `set_ln_impl`'s choice."""
    if ln is None:
        ln = _resolve_ln()
    recompute = _remat_enabled(remat) and torch.is_grad_enabled()
    n_layers = stacked_params["attn"]["qkv_w"].shape[0]
    for i in range(n_layers):
        args = (x, _layer(stacked_params, i), num_heads, attn_bias, impl, None, ln)
        x = checkpoint(residual_block, *args, use_reentrant=False) if recompute else residual_block(*args)
    return x


def transformer_with_act_stats(
    x: torch.Tensor,
    stacked_params: dict,
    num_heads: int,
    attn_bias: Optional[torch.Tensor] = None,
):
    """`transformer`'s forward that also returns the per-layer dense-input
    abs-max stats, stacked as the params are ({"attn": {qkv_w: [L],
    out_w: [L]}, "mlp": {fc_w: [L], proj_w: [L]}}): the calibration pass
    for static int8 scales. Always the plain attention path (the JAX
    package's runs its einsum path), no remat."""
    per_layer = []
    for i in range(stacked_params["attn"]["qkv_w"].shape[0]):
        stats: dict = {}
        x = residual_block(x, _layer(stacked_params, i), num_heads, attn_bias, "plain", stats)
        per_layer.append(stats)
    stacked = {
        group: {k: torch.stack([s[group][k] for s in per_layer]) for k in per_layer[0][group]}
        for group in per_layer[0]
    }
    return x, stacked


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
