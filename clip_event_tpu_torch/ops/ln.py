"""Fused LayerNorm over the last axis: K4, forward and backward.

Counterpart of `clip_event_tpu/ops/ln_pallas.py`. The public names map as

    layer_norm_pallas      → fused_layer_norm          (K4a)
    add_layer_norm_pallas  → fused_add_layer_norm      (K4b)
    _ln_bwd_call           → fused_layer_norm_bwd      (K4c, shared by both)
    ln_supported           → ln_supported

`fused_layer_norm(x, scale, bias)` is y = LN(x)·γ + β with the statistics
and the normalize in float32 and the output in x's dtype.
`fused_add_layer_norm(res, delta, scale, bias)` returns (x, y) with
x = res + delta rounded to the I/O dtype and y = LN(x): the residual add
rides on the LayerNorm's one read. Both are `torch.autograd.Function`s that
save x (for K4b the sum), γ and β, never the statistics, so they compose
with `torch.utils.checkpoint`. The backward recomputes the statistics:
g = dy·γ, dx = (g − mean(g) − x̂·mean(g·x̂))·rstd in x's dtype,
dγ = Σ_rows dy·x̂ and dβ = Σ_rows dy summed in float32 and cast to γ's and
β's dtype. For K4b the gradient of both inputs is dx_out + dx, where dx is
first rounded to the I/O dtype and the add runs there (the roundings of the
JAX code, which adds outside its kernel).

On a CUDA tensor the forwards launch `csrc/layer_norm.cu` and the backward
`csrc/layer_norm_bwd.cu` (two launches a call: the row pass, which leaves
per-block partial column sums in an fp32 scratch, and their reduction in a
fixed order, so the result is the same from run to run), or they raise. On
a CPU tensor they run `layer_norm_plain`, `add_layer_norm_plain` and
`layer_norm_bwd_plain`, the same functions in plain PyTorch. Nothing falls
back from a kernel to its plain version. A width the kernels do not take
(`ln_supported`) raises on every device, the CPU included, so a CPU run
shows what a run on the card would do; the JAX package warns and runs its
XLA LayerNorm there instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from clip_event_tpu_torch.ops import _build

KERNEL = "layer_norm"
BWD_KERNEL = "layer_norm_bwd"
# the kernels hold a row (the backward: four rows' worth) per warp in shared
# memory as fp32: 4 warps × 4·W·4 bytes ≤ 227 KB
MAX_WIDTH = 3072
ROWS_PER_BLOCK = 4  # one warp per row
# the backward's C entry point launches two kernels (row pass, reduction)
BWD_LAUNCHES_PER_CALL = 2
_SMEM_PER_BLOCK = 227 * 1024
_MAX_BLOCKS_PER_SM = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ln_supported(width: int) -> bool:
    """The widths K4 takes: every CLIP preset's (512, 640, 768, 1024, 1280)
    and any other up to MAX_WIDTH. (The TPU kernels need W % 128 == 0, a
    lane rule that does not carry over.)"""
    return 1 <= width <= MAX_WIDTH


# ------------------------------------------------------------------ plain


def _xhat(x32: torch.Tensor, eps: float):
    """(x̂, rstd) in fp32: mean, then the variance of the centred values
    (`_stats` of the JAX kernels)."""
    c = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    return c * rstd, rstd


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """K4a in plain PyTorch (the math of `_ln_fwd_kernel`)."""
    xhat, _ = _xhat(x.float(), eps)
    return (xhat * scale.float() + bias.float()).to(x.dtype)


def add_layer_norm_plain(
    res: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4b in plain PyTorch (`_add_ln_fwd_kernel`): the sum is rounded to
    the I/O dtype first, and the LayerNorm reads the rounded value."""
    x = res + delta
    return x, layer_norm_plain(x, scale, bias, eps)


def layer_norm_bwd_plain(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
    dx_out: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4c in plain PyTorch (`_ln_bwd_kernel`): (dx in x's dtype, dγ, dβ in
    fp32) from the saved x and the output's cotangent. With `dx_out` (K4b:
    the cotangent of the sum) dx is rounded to x's dtype, then added to it
    there (`_add_ln_bwd`)."""
    xhat, rstd = _xhat(x.float(), eps)
    dy32 = dy.float()
    g = dy32 * scale.float()
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = ((g - m1 - xhat * m2) * rstd).to(x.dtype)
    if dx_out is not None:
        dx = dx_out + dx
    w = x.shape[-1]
    dg = (dy32 * xhat).reshape(-1, w).sum(dim=0)
    db = dy32.reshape(-1, w).sum(dim=0)
    return dx, dg, db


# ----------------------------------------------------------------- kernels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]


def _check_width(width: int) -> None:
    if not ln_supported(width):
        raise ValueError(
            f"the LayerNorm kernels take 1 <= W <= {MAX_WIDTH}, got W={width} "
            "(set_ln_impl('xla') runs any width)"
        )


def _check_kernel_input(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                        *same: Optional[torch.Tensor]) -> None:
    w = x.shape[-1] if x.dim() else 0
    _check_width(w)
    if x.dtype not in _DTYPES:
        raise ValueError(f"LayerNorm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("LayerNorm kernel needs at least one row")
    for v in (scale, bias):
        if v is not None and (tuple(v.shape) != (w,) or v.device != x.device):
            raise ValueError(f"scale and bias must be [{w}] on {x.device}, got {tuple(v.shape)} on {v.device}")
    for t in same:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device):
            raise ValueError(
                f"LayerNorm kernel operands must share x's {tuple(x.shape)}, {x.dtype}, {x.device}; "
                f"got {tuple(t.shape)}, {t.dtype}, {t.device}"
            )
    if x.device.type != "cuda":
        raise ValueError(f"LayerNorm kernel needs a CUDA tensor, got {x.device}")


def _vec(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(x, delta, scale, bias, eps):
    """Check and launch the forward kernel: K4a (delta None) or K4b.
    Returns (sum or None, y)."""
    _check_kernel_input(x, scale, bias, delta)
    w = x.shape[-1]
    x = x.contiguous()
    delta = None if delta is None else delta.contiguous()
    lib, fn = _build.entry(KERNEL, "clip_layer_norm_fwd", _FWD_ARGS)
    y = torch.empty_like(x)
    xsum = None if delta is None else torch.empty_like(x)
    g, b = _vec(scale), _vec(bias)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), _ptr(delta), g.data_ptr(), b.data_ptr(), _ptr(xsum), y.data_ptr(),
                  x.numel() // w, w, float(eps), _DTYPES[x.dtype], stream)
    _build.check(lib, code, f"{KERNEL} launch")
    return xsum, y


def bwd_blocks(n_rows: int, width: int, sm_count: int) -> int:
    """Row-blocks of the backward's first launch: enough to fill the card's
    SMs as far as a block's shared memory (4 warps × 4 fp32 rows) allows,
    never more than the rows need. Each block loops over its rows and
    leaves one [2, W] partial, so the scratch stays a few hundred rows."""
    smem = ROWS_PER_BLOCK * 4 * width * 4
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM, _SMEM_PER_BLOCK // smem))
    return max(1, min(-(-n_rows // ROWS_PER_BLOCK), sm_count * per_sm))


def _launch_bwd(x, scale, dy, dx_out, eps):
    """Check and launch K4c's two kernels on a CUDA tensor."""
    _check_kernel_input(x, scale, None, dy, dx_out)
    w = x.shape[-1]
    n = x.numel() // w
    x, dy = x.contiguous(), dy.contiguous()
    dx_out = None if dx_out is None else dx_out.contiguous()
    lib, fn = _build.entry(BWD_KERNEL, "clip_layer_norm_bwd", _BWD_ARGS)
    blocks = bwd_blocks(n, w, torch.cuda.get_device_properties(x.device).multi_processor_count)
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, 2, w), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, w), dtype=torch.float32, device=x.device)
    g = _vec(scale)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), g.data_ptr(), dy.data_ptr(), _ptr(dx_out), dx.data_ptr(),
                  partial.data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(),
                  n, w, blocks, float(eps), _DTYPES[x.dtype], stream)
    _build.check(lib, code, f"{BWD_KERNEL} launch")
    return dx, dgb[0], dgb[1]


def _ln_fwd(x, scale, bias, eps):
    """K4a: the plain version on a CPU tensor, the kernel on a CUDA tensor
    it takes, else raise."""
    _check_width(x.shape[-1])
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _, y = _launch_fwd(x, None, scale, bias, eps)
    fused_layer_norm.launches += 1
    return y


def _add_ln_fwd(res, delta, scale, bias, eps):
    """K4b: the plain version on CPU tensors, the kernel on CUDA tensors it
    takes, else raise."""
    _check_width(res.shape[-1])
    if res.device.type == "cpu":
        return add_layer_norm_plain(res, delta, scale, bias, eps)
    out = _launch_fwd(res, delta, scale, bias, eps)
    fused_add_layer_norm.launches += 1
    return out


def fused_layer_norm_bwd(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
    dx_out: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4c: (dx in x's dtype, dγ, dβ in fp32) from the saved x [..., W], γ
    [W] and the cotangent dy of y; with `dx_out`, the cotangent of K4b's
    sum, dx is dx_out + dx. CPU tensors take the plain version; any other
    device must be a CUDA tensor the kernel takes, else this raises."""
    _check_width(x.shape[-1])
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, dy, dx_out, eps)
    out = _launch_bwd(x, scale, dy, dx_out, eps)
    fused_layer_norm_bwd.launches += BWD_LAUNCHES_PER_CALL
    return out


class _FusedLayerNorm(torch.autograd.Function):
    """K4a with its gradient (`_ln_fwd` / `_ln_bwd`): saves x, γ and β."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _ln_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dg, db = fused_layer_norm_bwd(x, scale, dy, None, ctx.eps)
        return dx, dg.to(scale.dtype), db.to(bias.dtype), None


class _FusedAddLayerNorm(torch.autograd.Function):
    """K4b with its gradient (`_add_ln_fwd` / `_add_ln_bwd`): saves the sum,
    γ and β. Either cotangent may be missing (None, not a zero tensor):
    without dy the inputs get dx_out and γ, β nothing; without dx_out they
    get the LayerNorm's dx."""

    @staticmethod
    def forward(ctx, res, delta, scale, bias, eps):
        x, y = _add_ln_fwd(res, delta, scale, bias, eps)
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return x, y

    @staticmethod
    def backward(ctx, dx_out, dy):
        x, scale, bias = ctx.saved_tensors
        if dy is None:
            return dx_out, dx_out, None, None, None
        din, dg, db = fused_layer_norm_bwd(x, scale, dy, dx_out, ctx.eps)
        return din, din, dg.to(scale.dtype), db.to(bias.dtype), None


def fused_layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis in one read and one write, with its
    gradient (K4a). x: [..., W]; scale, bias: [W]. fp32 statistics, output
    in x.dtype: the numerics of `models.layers.layer_norm`. CPU tensors take
    the plain versions; any other device must be a CUDA tensor the kernels
    take (fp32 or bf16, `ln_supported`), else this raises."""
    return _FusedLayerNorm.apply(x, scale, bias, float(eps))


def fused_add_layer_norm(
    res: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) = (res + delta, LayerNorm(res + delta)) in one kernel, with
    its gradient (K4b): the gradient of res and of delta is the sum's
    cotangent plus the LayerNorm's dx. Devices as `fused_layer_norm`."""
    return _FusedAddLayerNorm.apply(res, delta, scale, bias, float(eps))


# kernel launches since the last reset (chip_smoke.py reads and resets them):
# one per forward call, BWD_LAUNCHES_PER_CALL per backward call
fused_layer_norm.launches = 0
fused_add_layer_norm.launches = 0
fused_layer_norm_bwd.launches = 0
