"""K1, K2 and K5 as `torch.library` custom ops, for programs that
`torch.export` writes (the serving bundle, `engine/export.py`).

The kernel wrappers pick the kernel or the plain version by the device of
their input in Python and launch through ctypes. `torch.export` traces on
fake tensors, where neither a device test nor a ctypes launch means
anything: it would bake the branch it saw into the program. An op of this
module is one node of the program instead, with one implementation a
device:

* `attention_core(qkv, bias, num_heads, scale)`: the attention core over
  the packed [B, S, 3W] projection, [B, S, W] out. On a CPU tensor the
  plain version (`ops.attention.fused_attention_qkv_plain`); on a CUDA
  tensor K1 (`fused_attention_qkv_fwd`) or K2
  (`fused_attention_qkv_headgrid_fwd`), as `ops.attention.core_kernel`
  picks by S, W and H, the choice `models.layers.attention_core` makes.
* `quantized_linear(x, q, scale, act_scale, bias)`: K5's W8A8 product of
  x [M, K] and the K-major int8 q [K, N], [M, N] in x's dtype; dynamic
  per-row activation scales, or the static `act_scale`. On a CPU tensor
  `ops.quant.quantized_matmul_plain`, on a CUDA tensor
  `quantized_matmul`.

The CUDA implementations call the wrappers, so each call of an exported
program advances the wrappers' `.launches` as the live model does, and
they launch the kernel or raise, as the wrappers do: none runs the plain
version. A device other than the CPU and CUDA has no implementation. The
fake implementations read shapes and dtypes alone (never strides: q is
K-major, and the wrappers check layouts on the card). The ops are forward
only: training keeps the autograd Functions of `ops.attention`.

`models.layers.attention_core` and `ops.quant.quantized_linear` call these
ops only while `torch.export` traces (`torch.compiler.is_exporting()`);
every other call runs the wrappers as before. Import this module before
`torch.export.load` of a program that holds the ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_event_tpu_torch.ops import attention as A
from clip_event_tpu_torch.ops import quant as Q

NAMESPACE = "clip_event_tpu"


@torch.library.custom_op(f"{NAMESPACE}::attention_core", mutates_args=(), device_types="cpu")
def attention_core(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
                   scale: float) -> torch.Tensor:
    """The attention core on a CPU tensor: the plain version."""
    return A.fused_attention_qkv_plain(qkv, bias, num_heads, scale)


@attention_core.register_kernel("cuda")
def _attention_core_cuda(qkv, bias, num_heads, scale):
    B, S, W3 = qkv.shape
    fwd = A.fused_attention_qkv_fwd if A.core_kernel(S, W3 // 3, num_heads) == "k1" \
        else A.fused_attention_qkv_headgrid_fwd
    return fwd(qkv, bias, num_heads, scale)[0]


@attention_core.register_fake
def _attention_core_fake(qkv, bias, num_heads, scale):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3W], got {tuple(qkv.shape)}")
    S, W = qkv.shape[1], qkv.shape[2] // 3
    A.core_kernel(S, W, num_heads)  # raises where no kernel takes the shape
    return qkv.new_empty((qkv.shape[0], S, W))


@torch.library.custom_op(f"{NAMESPACE}::quantized_linear", mutates_args=(), device_types="cpu")
def quantized_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     act_scale: Optional[torch.Tensor], bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K5's product on a CPU tensor: the plain version."""
    return Q.quantized_matmul_plain(x, q, scale, bias, act_scale)


@quantized_linear.register_kernel("cuda")
def _quantized_linear_cuda(x, q, scale, act_scale, bias):
    return Q.quantized_matmul(x, q, scale, bias, act_scale)


@quantized_linear.register_fake
def _quantized_linear_fake(x, q, scale, act_scale, bias):
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"quantized_linear takes x [M, K] and q [K, N], got {tuple(x.shape)} "
                         f"and {tuple(q.shape)}")
    return x.new_empty((x.shape[0], q.shape[1]))
