"""Multi-head attention over the packed QKV projection: K1 and K2, each
forward and backward, and K6, the LayerNorm → QKV → attention megakernel.

Counterpart of `clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv`
(K1) and `fused_attention_qkv_headgrid` (K2) with their custom VJPs. Both
have one contract: the attention core reads the raw [B, S, 3W] output of
the fused QKV matmul (torch/CLIP lane layout: q in [0, W), k in [W, 2W), v
in [2W, 3W), head h at h·D in each) and returns the head outputs
concatenated as [B, S, W], ready for the out-projection. Its gradient is
written packed as [B, S, 3W] from qkv and the output's cotangent alone (P
is recomputed, never saved); the bias gets none.

`fused_attention_qkv` is a `torch.autograd.Function`. On a CUDA tensor its
forward launches the hand-written kernel of `csrc/attention_fwd.cu` and
its backward the one of `csrc/attention_bwd.cu`, or they raise if the
kernel cannot take the input. Those kernels stage a whole head's K and V
in shared memory, so they take S <= 128. `fused_attention_qkv_headgrid`
is the same function for the longer sequences of the ViT-B/16 and ViT-L/14
vision towers (S = 197, 257): its kernels, `csrc/attention_hg_fwd.cu` and
`csrc/attention_hg_bwd.cu`, walk K and V in tiles with an online softmax,
so any S runs; they take the head-grid shapes of the JAX kernel
(`head_grid_supported`). On a CPU tensor both run
`fused_attention_qkv_plain` and `fused_attention_qkv_bwd_plain`, the same
function in plain PyTorch. Nothing falls back from a kernel to its plain
version. `attend(..., impl="plain")` runs the plain pair on any device: the
reference a run on the card is held against.

`fused_ln_qkv_attention` (K6, the counterpart of the JAX function of the
same name) computes LayerNorm → the packed QKV projection → K1's attention
core in one kernel, `csrc/ln_qkv_attention.cu`, forward only: neither the
normalized rows nor the [B, S, 3W] projection reach device memory. It is a
measurement vehicle (`tools/bench_components.py megakernel`), not on the
train path. `fused_ln_qkv_attention_plain` is the same function in plain
PyTorch, with the kernel's roundings.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from clip_event_tpu_torch.ops import _build

MAX_SEQ = 128
MAX_HEAD_DIM = 128
KERNEL = "attention_fwd"
BWD_KERNEL = "attention_bwd"
HG_KERNEL = "attention_hg_fwd"
HG_BWD_KERNEL = "attention_hg_bwd"
# each backward's C entry point launches two kernels (dq pass, dk/dv pass)
BWD_LAUNCHES_PER_CALL = 2
# K2 takes heads in 128-lane groups, as the TPU kernel's lane blocks do
HG_LANES = 128
MEGA_KERNEL = "ln_qkv_attention"
# K6 keeps a head's q, k and v in shared memory beside its tiles, and each
# thread owns 4 neighbouring columns of the projection
MEGA_MAX_SEQ = 128
MEGA_MAX_HEAD_DIM = 64
IMPLS = ("kernel", "plain")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _wide(t: torch.Tensor) -> torch.Tensor:
    """fp32 for fp32 and narrower types; float64 stays float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _split_probs(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float):
    """q, k, v as [B, H, S, D] fp32 views and P = softmax(q·scale·kᵀ + bias)
    in fp32 (`_split_heads` / `_probs`)."""
    B, S, W3 = qkv.shape
    x = _wide(qkv).view(B, S, 3, num_heads, W3 // 3 // num_heads)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + _wide(bias)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return q, k, v, p / p.sum(dim=-1, keepdim=True)


def fused_attention_qkv_plain(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """softmax(q·scale·kᵀ + bias)·v per head in fp32, output in qkv.dtype
    (the math of `_fwd_kernel` / `_probs`)."""
    B, S, W3 = qkv.shape
    _, _, v, p = _split_probs(qkv, bias, num_heads, scale)
    out = torch.matmul(p, v)
    return out.transpose(1, 2).reshape(B, S, W3 // 3).to(qkv.dtype)


def fused_attention_qkv_bwd_plain(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor, num_heads: int,
    scale: float,
) -> torch.Tensor:
    """dqkv [B, S, 3W] in qkv.dtype from qkv and the output's cotangent `do`
    [B, S, W], in fp32 ops (the formulas of `_bwd_kernel`): recompute P,
    dv = Pᵀ·do, dp = do·vᵀ, ds = P∘(dp − rowsum(dp∘P)), dq = ds·k·scale,
    dk = dsᵀ·q·scale."""
    B, S, W3 = qkv.shape
    q, k, v, p = _split_probs(qkv, bias, num_heads, scale)
    g = _wide(do).view(B, S, num_heads, -1).transpose(1, 2)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.stack([t.transpose(1, 2) for t in (dq, dk, dv)], dim=2)  # [B, S, 3, H, D]
    return dqkv.reshape(B, S, W3).to(qkv.dtype)


def head_grid_supported(seq_len: int, width: int, num_heads: int) -> bool:
    """The shapes K2 takes (the JAX `head_grid_supported` without its TPU
    VMEM byte model): W a multiple of 128 and head_dim dividing 128. Any
    sequence length runs."""
    if seq_len < 1 or width % num_heads or width % HG_LANES:
        return False
    return HG_LANES % (width // num_heads) == 0


def _check_kernel_input(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
    do: Optional[torch.Tensor] = None, head_grid: bool = False,
):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3W], got {tuple(qkv.shape)}")
    B, S, W3 = qkv.shape
    W = W3 // 3
    if W % num_heads:
        raise ValueError(f"width {W} not divisible by num_heads {num_heads}")
    D = W // num_heads
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("attention kernel needs a contiguous qkv")
    if head_grid:
        if not head_grid_supported(S, W, num_heads):
            raise ValueError(
                f"head-grid attention kernel takes W % {HG_LANES} == 0 and head_dim "
                f"dividing {HG_LANES}, got S={S} W={W} H={num_heads}"
            )
    else:
        if not 1 <= S <= MAX_SEQ:
            raise ValueError(f"attention kernel takes 1 <= S <= {MAX_SEQ}, got S={S}")
        if not 1 <= D <= MAX_HEAD_DIM:
            raise ValueError(f"attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {D}")
    if B < 1:
        raise ValueError("attention kernel needs B >= 1")
    if bias is not None:
        if tuple(bias.shape) != (S, S):
            raise ValueError(f"bias must be [S, S] = [{S}, {S}], got {tuple(bias.shape)}")
        if bias.device != qkv.device:
            raise ValueError("bias must be on qkv's device")
    if do is not None and (
        tuple(do.shape) != (B, S, W) or do.dtype != qkv.dtype or do.device != qkv.device
    ):
        raise ValueError(
            f"do must be [B, S, W] = {(B, S, W)} in {qkv.dtype} on {qkv.device}, "
            f"got {tuple(do.shape)} in {do.dtype} on {do.device}"
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"attention kernel needs a CUDA tensor, got {qkv.device}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P]


def _kernel_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    # the JAX wrapper casts the bias to fp32 too
    return None if bias is None else bias.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(qkv, bias, num_heads, scale, head_grid: bool) -> torch.Tensor:
    """Check and launch the forward kernel of K1 or K2 on a CUDA tensor."""
    _check_kernel_input(qkv, bias, num_heads, head_grid=head_grid)
    B, S, W3 = qkv.shape
    W = W3 // 3
    bias = _kernel_bias(bias)
    name, symbol = (HG_KERNEL, "clip_attention_hg_fwd") if head_grid else (KERNEL, "clip_attention_fwd")
    lib, fn = _build.entry(name, symbol, _FWD_ARGS)
    out = torch.empty((B, S, W), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(
            qkv.data_ptr(), _ptr(bias), out.data_ptr(),
            B, S, num_heads, W // num_heads, float(scale), _DTYPES[qkv.dtype], stream,
        )
    _build.check(lib, code, f"{name} launch")
    return out


def _launch_bwd(qkv, bias, do, num_heads, scale, head_grid: bool) -> torch.Tensor:
    """Check and launch the two backward kernels of K1 or K2 on a CUDA
    tensor; the softmax row stats go to a [3, B, H, S] fp32 scratch."""
    _check_kernel_input(qkv, bias, num_heads, do, head_grid=head_grid)
    B, S, W3 = qkv.shape
    W = W3 // 3
    do = do.contiguous()
    bias = _kernel_bias(bias)
    name, symbol = (
        (HG_BWD_KERNEL, "clip_attention_hg_bwd") if head_grid else (BWD_KERNEL, "clip_attention_bwd")
    )
    lib, fn = _build.entry(name, symbol, _BWD_ARGS)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, B, num_heads, S), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(
            qkv.data_ptr(), _ptr(bias), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            B, S, num_heads, W // num_heads, float(scale), _DTYPES[qkv.dtype], stream,
        )
    _build.check(lib, code, f"{name} launch")
    return dqkv


def _attention_fwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """K1's forward: the plain version on a CPU tensor, the kernel on a CUDA
    tensor it takes, else raise."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, bias, num_heads, scale)
    out = _launch_fwd(qkv, bias, num_heads, scale, head_grid=False)
    fused_attention_qkv.launches += 1
    return out


def fused_attention_qkv_bwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor, num_heads: int,
    scale: float,
) -> torch.Tensor:
    """dqkv [B, S, 3W] in qkv.dtype from qkv [B, S, 3W] and the output's
    cotangent do [B, S, W]. CPU tensors take the plain version; any other
    device must be a CUDA tensor the kernel takes (the forward's domain, with
    do of qkv's dtype), else this raises."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_bwd_plain(qkv, bias, do, num_heads, scale)
    dqkv = _launch_bwd(qkv, bias, do, num_heads, scale, head_grid=False)
    fused_attention_qkv_bwd.launches += BWD_LAUNCHES_PER_CALL
    return dqkv


def _headgrid_fwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """K2's forward: the plain version on a CPU tensor, the kernel on a CUDA
    tensor it takes, else raise."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, bias, num_heads, scale)
    out = _launch_fwd(qkv, bias, num_heads, scale, head_grid=True)
    fused_attention_qkv_headgrid.launches += 1
    return out


def fused_attention_qkv_headgrid_bwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor, num_heads: int,
    scale: float,
) -> torch.Tensor:
    """K2's backward: dqkv [B, S, 3W] packed as JAX's
    `concatenate([dq, dk, dv], -1)` lays it out. CPU tensors take the plain
    version; any other device must be a CUDA tensor K2 takes, else raise."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_bwd_plain(qkv, bias, do, num_heads, scale)
    dqkv = _launch_bwd(qkv, bias, do, num_heads, scale, head_grid=True)
    fused_attention_qkv_headgrid_bwd.launches += BWD_LAUNCHES_PER_CALL
    return dqkv


class _FusedAttention(torch.autograd.Function):
    """K1 with its gradient: saves qkv and bias (the residuals of
    `_fused_qkv_fwd`), not the probabilities; no gradient for the bias,
    num_heads, scale or the impl flag (`_fused_qkv_bwd` returns None)."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale, kernel):
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale, ctx.kernel = num_heads, scale, kernel
        if kernel:
            return _attention_fwd(qkv, bias, num_heads, scale)
        return fused_attention_qkv_plain(qkv, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        qkv, bias = ctx.saved_tensors
        bwd = fused_attention_qkv_bwd if ctx.kernel else fused_attention_qkv_bwd_plain
        return bwd(qkv, bias, do, ctx.num_heads, ctx.scale), None, None, None, None


class _HeadGridAttention(torch.autograd.Function):
    """K2 with its gradient, the counterpart of `_hg_fwd` / `_hg_bwd`: saves
    qkv and bias, not the probabilities, so it composes with
    `torch.utils.checkpoint`; no gradient for the bias."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _headgrid_fwd(qkv, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        qkv, bias = ctx.saved_tensors
        dqkv = fused_attention_qkv_headgrid_bwd(qkv, bias, do, ctx.num_heads, ctx.scale)
        return dqkv, None, None, None


def fused_attention_qkv(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """Multi-head softmax attention over a packed QKV projection, with its
    gradient (K1).

    qkv: [B, S, 3W]; bias: additive [S, S] float mask or None. Returns
    [B, S, W] in qkv.dtype. CPU tensors take the plain versions; any other
    device must be a CUDA tensor the kernels take (fp32 or bf16, contiguous,
    S <= 128, head_dim <= 128), else this raises."""
    return _FusedAttention.apply(qkv, bias, num_heads, float(scale), True)


def fused_attention_qkv_headgrid(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """`fused_attention_qkv`'s function and contract for any sequence length
    (K2, JAX `attention_pallas.py:490-496`): packed [B, S, 3W] in, [B, S, W]
    out, the gradient as packed dqkv, none for the bias. CPU tensors take
    the plain versions; any other device must be a CUDA tensor K2 takes
    (fp32 or bf16, contiguous, `head_grid_supported`), else this raises."""
    return _HeadGridAttention.apply(qkv, bias, num_heads, float(scale))


def attend(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    impl: str = "kernel",
) -> torch.Tensor:
    """`fused_attention_qkv` ("kernel") or its plain forward and backward on
    any device ("plain")."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; options: {IMPLS}")
    return _FusedAttention.apply(qkv, bias, num_heads, float(scale), impl == "kernel")


def megakernel_supported(seq_len: int, width: int, num_heads: int) -> bool:
    """The shapes K6 takes: S <= 128 and a head_dim <= 64 that is a multiple
    of 4 (the kernel's shared-memory layout; the JAX function's gate is its
    VMEM byte model). Any width with such heads runs."""
    if seq_len < 1 or num_heads < 1 or width < 1 or width % num_heads:
        return False
    d = width // num_heads
    return seq_len <= MEGA_MAX_SEQ and d <= MEGA_MAX_HEAD_DIM and d % 4 == 0


def fused_ln_qkv_attention_plain(
    x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor, qkv_w: torch.Tensor,
    qkv_b: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K6 in plain PyTorch, with the roundings of `_mega_fwd_kernel`: γ, β,
    the weight and its bias are cast to x's dtype first; the LayerNorm runs
    in fp32 and is rounded to x's dtype; the projection multiplies those
    rounded operands in fp32 (upcast first: a bf16 matmul would round its
    result) and is not rounded before the attention core; the probabilities
    stay fp32; the output is rounded to x's dtype. `bias=None` is no mask.
    On the card an fp32 input needs
    `torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default)."""
    dt = x.dtype
    g, b, w, wb = (_wide(t.to(dt)) for t in (ln_scale, ln_bias, qkv_w, qkv_b))
    x32 = _wide(x)
    c = x32 - x32.mean(dim=-1, keepdim=True)
    ln = c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    ln = _wide((ln * g + b).to(dt))
    qkv = torch.matmul(ln, w) + wb
    return fused_attention_qkv_plain(qkv, bias, num_heads, scale).to(dt)


_MEGA_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _P]


def _launch_mega(x, ln_scale, ln_bias, qkv_w, qkv_b, bias, num_heads, scale, eps) -> torch.Tensor:
    """Check and launch K6 on a CUDA tensor."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, W], got {tuple(x.shape)}")
    B, S, W = x.shape
    if not megakernel_supported(S, W, num_heads):
        raise ValueError(
            f"the megakernel takes S <= {MEGA_MAX_SEQ} and head_dim <= {MEGA_MAX_HEAD_DIM}, a "
            f"multiple of 4; got S={S} W={W} H={num_heads}"
        )
    if x.dtype not in _DTYPES:
        raise ValueError(f"the megakernel takes float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"the megakernel needs a CUDA tensor, got {x.device}")
    if B < 1:
        raise ValueError("the megakernel needs B >= 1")
    shapes = {"ln_scale": (ln_scale, (W,)), "ln_bias": (ln_bias, (W,)),
              "qkv_w": (qkv_w, (W, 3 * W)), "qkv_b": (qkv_b, (3 * W,))}
    if bias is not None:
        shapes["bias"] = (bias, (S, S))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got {tuple(t.shape)} on {t.device}")
    x = x.contiguous()
    # the JAX wrapper casts these to x's dtype before its kernel too
    g, b, w, wb = (t.detach().to(x.dtype).contiguous() for t in (ln_scale, ln_bias, qkv_w, qkv_b))
    bias = _kernel_bias(bias)
    lib, fn = _build.entry(MEGA_KERNEL, "clip_ln_qkv_attention", _MEGA_ARGS)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), wb.data_ptr(), _ptr(bias),
            out.data_ptr(), B, S, num_heads, W // num_heads, float(scale), float(eps),
            _DTYPES[x.dtype], stream,
        )
    _build.check(lib, code, f"{MEGA_KERNEL} launch")
    return out


def fused_ln_qkv_attention(
    x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor, qkv_w: torch.Tensor,
    qkv_b: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm → packed QKV projection → attention core, one kernel (K6).

    x: [B, S, W]; ln_scale, ln_bias: [W]; qkv_w: [W, 3W]; qkv_b: [3W]; bias:
    additive [S, S] mask or None. Returns [B, S, W] in x.dtype, the contract
    of `fused_attention_qkv` (before the out-projection). Forward only, as
    in the JAX package: it runs outside autograd, so where autograd records
    the result does not require grad. CPU tensors take the plain version;
    any other device must be a CUDA tensor the kernel takes (fp32 or bf16,
    `megakernel_supported`), else this raises."""
    if x.shape[-1] % num_heads:
        raise ValueError(f"width {x.shape[-1]} not divisible by num_heads {num_heads}")
    with torch.no_grad():
        if x.device.type == "cpu":
            return fused_ln_qkv_attention_plain(
                x, ln_scale, ln_bias, qkv_w, qkv_b, bias, num_heads, scale, eps)
        out = _launch_mega(x, ln_scale, ln_bias, qkv_w, qkv_b, bias, num_heads, scale, eps)
    fused_ln_qkv_attention.launches += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads and resets them):
# one per forward call, BWD_LAUNCHES_PER_CALL per backward call
fused_attention_qkv.launches = 0
fused_attention_qkv_bwd.launches = 0
fused_attention_qkv_headgrid.launches = 0
fused_attention_qkv_headgrid_bwd.launches = 0
fused_ln_qkv_attention.launches = 0
