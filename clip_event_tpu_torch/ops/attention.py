"""Multi-head attention over the packed QKV projection (the K1 forward).

Counterpart of `clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv`:
the attention core reads the raw [B, S, 3W] output of the fused QKV matmul
(torch/CLIP lane layout: q in [0, W), k in [W, 2W), v in [2W, 3W), head h at
h·D in each) and returns the head outputs concatenated as [B, S, W], ready
for the out-projection.

On a CUDA tensor the wrapper launches the hand-written kernel of
`csrc/attention_fwd.cu`, or raises if the kernel cannot take the input. On
a CPU tensor it runs `fused_attention_qkv_plain`, the same function in plain
PyTorch. Nothing falls back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from clip_event_tpu_torch.ops import _build

MAX_SEQ = 128
MAX_HEAD_DIM = 128
KERNEL = "attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_qkv_plain(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """softmax(q·scale·kᵀ + bias)·v per head in fp32, output in qkv.dtype
    (the math of `_fwd_kernel` / `_probs`)."""
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // num_heads
    x = qkv.float().view(B, S, 3, num_heads, D)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))  # [B, H, S, D] each
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v)
    return out.transpose(1, 2).reshape(B, S, W).to(qkv.dtype)


def _check_kernel_input(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int):
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
    if qkv.device.type != "cuda":
        raise ValueError(f"attention kernel needs a CUDA tensor, got {qkv.device}")


def _load():
    lib = _build.load(KERNEL)
    fn = lib.clip_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def fused_attention_qkv(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """Multi-head softmax attention over a packed QKV projection.

    qkv: [B, S, 3W]; bias: additive [S, S] float mask or None. Returns
    [B, S, W] in qkv.dtype. CPU tensors take the plain version; any other
    device must be a CUDA tensor the kernel takes (fp32 or bf16, contiguous,
    S <= 128, head_dim <= 128), else this raises."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, bias, num_heads, scale)
    _check_kernel_input(qkv, bias, num_heads)
    B, S, W3 = qkv.shape
    W = W3 // 3
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()  # the JAX wrapper casts too
    lib, fn = _load()
    out = torch.empty((B, S, W), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, S, num_heads, W // num_heads, float(scale), _DTYPES[qkv.dtype], stream,
        )
    _build.check(lib, code, "attention_fwd launch")
    fused_attention_qkv.launches += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads and resets it)
fused_attention_qkv.launches = 0
