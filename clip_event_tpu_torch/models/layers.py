"""Building blocks shared by the vision and text towers, as plain functions
on tensors (counterpart of `clip_event_tpu/models/layers.py`).

Params are nested dicts of tensors with the JAX package's names and
layouts: dense weights input-major `[in, out]`, transformer layers stacked
along a leading `[L, ...]` axis. LayerNorm always runs in float32 (the fp32
island); matmuls run in the activations' dtype.

`impl` selects the attention core: "kernel" calls
`ops.attention.fused_attention_qkv` (K1) where S <= 128, else
`fused_attention_qkv_headgrid` (K2) where `head_grid_supported`, else
raises; each launches its hand-written kernels (forward and backward) on a
CUDA tensor and runs their plain versions on a CPU tensor. "plain" runs
those plain versions on any device, the reference a run on the card is
held against; "rounded" runs them with the roundings of the kernels'
tensor-core variants (P and dS in bf16) where an input takes that
variant, the reference of the kernel path itself in bf16. None (the default everywhere) takes the process-wide choice
of `set_attention_impl` ("kernel" unless a caller changed it: the eval
CLIs, `embed` and the train loop's validation set it from
`use_pallas_attention`, the JAX package's `set_attention_impl`);
`transformer` resolves it once and hands every block the resolved value,
through `torch.utils.checkpoint` too. In fp32 both equal the JAX package's
einsum path; in bf16 the plain versions keep the probabilities in fp32 as
the JAX kernel path does, the tensor-core variants of K1 and K2 round them
to bf16 before P·V as the JAX einsum path does.

`remat` (the JAX package's `transformer(..., remat=)`, its
`_REMAT_POLICIES`): False saves every activation; True or "full"
recomputes each block in the backward pass (`torch.utils.checkpoint`, the
counterpart of `jax.checkpoint(..., nothing_saveable)`); "dots" keeps the
outputs of the matmul ops (mm, addmm, bmm, baddbmm) across the recompute
and "dots_nobatch" only the unbatched ones (mm, addmm: the projections),
through `create_selective_checkpoint_contexts` (`dots_saveable`,
`dots_with_no_batch_dims_saveable`); the attention kernels are
`autograd.Function`s launched through ctypes, not dispatcher ops, so they
are recomputed there, as JAX recomputes a `pallas_call` under its dot
policies. "attn" keeps only each block's attention-core output (JAX's
`save_only_these_names("attn_core_out")`) and the [B, H, S] log-sum-exp
the tensor-core backwards read: `_AttentionSaved` keeps the block input,
that output and the lse, and its backward recomputes `ln_1` and the QKV
projection from the input and runs the core's backward on them
(`ops.attention.attention_core_bwd`); the rest of the block is
checkpointed from (input, attention output). The attention forward runs
once a step there, twice under "full". An unknown name raises ValueError.

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
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from clip_event_tpu_torch.ops import attention as A
from clip_event_tpu_torch.ops import library
from clip_event_tpu_torch.ops import ln as LN
from clip_event_tpu_torch.ops.attention import IMPLS
from clip_event_tpu_torch.ops.quant import QuantWeight, quantized_linear

# the JAX package's remat policies (`layers.py:465-475`); "dots" and
# "dots_nobatch" keep the outputs of these ops across the recompute
REMAT_POLICIES = ("full", "dots", "dots_nobatch", "attn")
_aten = torch.ops.aten
_SAVED_OPS = {
    "dots": [_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default],
    "dots_nobatch": [_aten.mm.default, _aten.addmm.default],
}


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
_ATTENTION_IMPL = "kernel"


def _check_mesh(mesh) -> None:
    """The JAX package's `mesh` argument of the impl setters shard_maps its
    kernels over the chips of a mesh. Here each rank's kernel runs on its
    own rows, so a data-parallel mesh of the port (`parallel.mesh.Mesh`)
    needs no wrapper; anything else is refused."""
    from clip_event_tpu_torch.parallel.mesh import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a clip_event_tpu_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")


def set_attention_impl(impl: str, mesh=None) -> None:
    """Select the attention core for every later call that passes no
    `impl`: "kernel" (K1 / K2, the default) or "plain" (their plain
    versions on any device): the JAX package's
    `set_attention_impl("pallas" | "xla", mesh)`; or "rounded" (the plain
    versions with the tensor-core variants' roundings), which has no JAX
    counterpart. `mesh`: a data-parallel mesh of the port, or None (the
    same choice either way, `_check_mesh`)."""
    global _ATTENTION_IMPL
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; options: {IMPLS}")
    _check_mesh(mesh)
    _ATTENTION_IMPL = impl


def _resolve_attention(impl: Optional[str] = None) -> str:
    """`impl`, or the process-wide attention choice (`set_attention_impl`)
    for None."""
    impl = _ATTENTION_IMPL if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; options: {IMPLS}")
    return impl


@contextlib.contextmanager
def attention_impl(impl: str):
    """`with attention_impl("plain"):` selects the attention core of the
    calls inside that pass no `impl` and puts the previous choice back
    after."""
    old = _resolve_attention()
    set_attention_impl(impl)
    try:
        yield
    finally:
        set_attention_impl(old)


def set_ln_impl(impl: str, mesh=None) -> None:
    """Select the LayerNorm of the transformer blocks for every later
    `transformer` call that passes no `ln`: "xla" (plain PyTorch, the
    default) or "pallas" (the fused kernels of `ops.ln`). `mesh`: a
    data-parallel mesh of the port, or None (the same choice either way,
    `_check_mesh`)."""
    global _LN_IMPL
    if impl not in LN_IMPLS:
        raise ValueError("ln impl must be 'xla' or 'pallas'")
    _check_mesh(mesh)
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
    impl: Optional[str] = None,
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
    impl: Optional[str] = None,
) -> torch.Tensor:
    """The attention core over the packed projection, chosen by shape alone
    before anything launches (JAX `layers.py:285-311`): K1 where S <= 128
    and head_dim <= 128, else K2 where `head_grid_supported`, else a
    ValueError naming the shape. The JAX package sends that last case to its
    einsum path; here it raises on every device, so a CPU run shows what a
    card run would do. No CLIP preset reaches it. `impl="plain"` (or
    "rounded") runs the plain versions at any shape; None takes
    `set_attention_impl`'s choice. While `torch.export` traces, "kernel"
    is the custom op `ops.library.attention_core` (forward only), which
    makes the same choice when the exported program runs."""
    impl = _resolve_attention(impl)
    if impl != "kernel":
        return A.attend(qkv, attn_bias, num_heads, scale, impl)
    if torch.compiler.is_exporting():
        return library.attention_core(qkv, attn_bias, num_heads, float(scale))
    B, S, W3 = qkv.shape
    if A.core_kernel(S, W3 // 3, num_heads) == "k1":
        return A.fused_attention_qkv(qkv, attn_bias, num_heads, scale)
    return A.fused_attention_qkv_headgrid(qkv, attn_bias, num_heads, scale)


def residual_block(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    attn_bias: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
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
    return _block_tail(x, a, params, ln_plan, mlp_stats)


def _block_tail(x: torch.Tensor, a: torch.Tensor, params: dict, ln_plan: str,
                mlp_stats: Optional[dict] = None) -> torch.Tensor:
    """A block after its attention (`a`, out-projected): the residual add +
    `ln_2`, then the QuickGELU MLP and its residual add."""
    x, h = _add_ln_apply(x, a, params["ln_2"], ln_plan)
    if mlp_stats is not None:
        mlp_stats["fc_w"] = _absmax(h)
    h = quick_gelu(linear(h, params["mlp"]["fc_w"], params["mlp"]["fc_b"]))
    if mlp_stats is not None:
        mlp_stats["proj_w"] = _absmax(h)
    return x + linear(h, params["mlp"]["proj_w"], params["mlp"]["proj_b"])


def _project(x, ln_scale, ln_bias, qkv_w, qkv_b, ln_plan: str) -> torch.Tensor:
    """ln_1 → the packed QKV projection of one block."""
    return linear(_ln_apply(x, {"scale": ln_scale, "bias": ln_bias}, ln_plan), qkv_w, qkv_b)


class _AttentionSaved(torch.autograd.Function):
    """ln_1 → QKV projection → attention core of one block under remat
    "attn": saves the block input, the ln_1 and projection params, the
    core's output and its lse (`ops.attention.attention_core_fwd`), not the
    [B, S, 3W] projection. The backward recomputes ln_1 and the projection
    from the input with autograd on, runs the core's backward on the saved
    output and lse (`attention_core_bwd`; the plain backward for impl
    "plain" and "rounded") and takes the projection's and ln_1's gradients
    from there. The attention forward runs once."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, attn_bias, num_heads, impl, ln_plan):
        ctx.num_heads, ctx.impl, ctx.ln_plan = num_heads, impl, ln_plan
        ctx.scale = (x.shape[-1] // num_heads) ** -0.5
        qkv = _project(x, ln_scale, ln_bias, qkv_w, qkv_b, ln_plan)
        out, lse = A.attention_core_fwd(qkv, attn_bias, num_heads, ctx.scale, impl)
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, attn_bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        x, ln_scale, ln_bias, qkv_w, qkv_b, attn_bias, out, lse = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, ln_scale, ln_bias, qkv_w, qkv_b), needs)]
        with torch.enable_grad():
            qkv = _project(*inputs, ctx.ln_plan)
        dqkv = A.attention_core_bwd(qkv.detach(), attn_bias, do, ctx.num_heads, ctx.scale,
                                    out, lse, ctx.impl)
        wanted = [t for t, need in zip(inputs, needs) if need]
        grads = iter(torch.autograd.grad(qkv, wanted, dqkv) if wanted else ())
        return (*(next(grads) if need else None for need in needs), None, None, None, None)


def _attn_tail(x, out, params, ln_plan):
    """The block from (input, attention-core output) on."""
    a = linear(out, params["attn"]["out_w"], params["attn"]["out_b"])
    return _block_tail(x, a, params, ln_plan)


def _remat_block(x, params, num_heads, attn_bias, impl, ln, policy: Optional[str]):
    """One residual block under a `remat_policy` (None: no recompute)."""
    if policy is None:
        return residual_block(x, params, num_heads, attn_bias, impl, None, ln)
    if policy == "attn":
        plan = _block_ln_plan(ln, None)
        out = _AttentionSaved.apply(
            x, params["ln_1"]["scale"], params["ln_1"]["bias"], params["attn"]["qkv_w"],
            params["attn"]["qkv_b"], attn_bias, num_heads, impl, plan)
        return checkpoint(_attn_tail, x, out, params, plan, use_reentrant=False,
                          preserve_rng_state=False)
    kw = {}
    if policy in _SAVED_OPS:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _SAVED_OPS[policy])
    # nothing in a block draws random numbers: no RNG state to keep (and a
    # CUDA graph capture may not read the generator's)
    return checkpoint(residual_block, x, params, num_heads, attn_bias, impl, None, ln,
                      use_reentrant=False, preserve_rng_state=False, **kw)


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked param tree; a QuantWeight slices its q, scale
    and act_scale ([L] → one scalar)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def remat_policy(remat) -> Optional[str]:
    """None for no remat (a false value), else the policy's name: True is
    "full"; a name not in REMAT_POLICIES raises ValueError (JAX
    `layers.py:549-552`)."""
    if not remat:
        return None
    mode = "full" if remat is True else str(remat)
    if mode not in REMAT_POLICIES:
        raise ValueError(f"remat mode {mode!r}; options: {list(REMAT_POLICIES)}")
    return mode


def transformer(
    x: torch.Tensor,
    stacked_params: dict,
    num_heads: int,
    attn_bias: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    remat=False,
    ln: Optional[str] = None,
) -> torch.Tensor:
    """Run the stack of residual blocks over the leading L axis of the params,
    each block under the `remat` policy (module docstring) when autograd is
    recording. `ln` None takes `set_ln_impl`'s choice, `impl` None
    `set_attention_impl`'s."""
    if ln is None:
        ln = _resolve_ln()
    impl = _resolve_attention(impl)
    policy = remat_policy(remat)
    if not torch.is_grad_enabled():
        policy = None
    n_layers = stacked_params["attn"]["qkv_w"].shape[0]
    for i in range(n_layers):
        x = _remat_block(x, _layer(stacked_params, i), num_heads, attn_bias, impl, ln, policy)
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
