"""Every kernel wrapper's launch count in one place.

Each wrapper adds to its own `.launches` where it launches its kernel on
the card (`ops.attention`, `ops.ln`, `ops.ot`, `ops.quant`). A CUDA graph
replay runs no Python, so the graphed train step
(`engine.train_step.make_multi_step`) takes the counts' growth over its
capture as what one replay launches, puts the counts back after the
capture (a capture records kernels, it launches none) and adds that growth
once a replay (`add`).
"""

from __future__ import annotations

from typing import Dict

from clip_event_tpu_torch.ops import attention, ln, ot, quant

# name → the wrapper whose `.launches` counts that kernel's launches
WRAPPERS = {
    "attention_fwd": attention.fused_attention_qkv,
    "attention_bwd": attention.fused_attention_qkv_bwd,
    "attention_hg_fwd": attention.fused_attention_qkv_headgrid,
    "attention_hg_bwd": attention.fused_attention_qkv_headgrid_bwd,
    "ln_qkv_attention": attention.fused_ln_qkv_attention,
    "layer_norm": ln.fused_layer_norm,
    "add_layer_norm": ln.fused_add_layer_norm,
    "layer_norm_bwd": ln.fused_layer_norm_bwd,
    "ipot": ot.ipot_kernel,
    "quant_matmul": quant.quantized_matmul,
    "quantize_rows": quant.quantize_rows,
    "quantized_gemm": quant.quantized_gemm,
}


def snapshot() -> Dict[str, int]:
    """Every count as it stands."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def restore(counts: Dict[str, int]) -> None:
    """Set the counts to a `snapshot`."""
    for name, n in counts.items():
        WRAPPERS[name].launches = n


def add(delta: Dict[str, int]) -> None:
    """Add launches a graph replay made to the counts."""
    for name, n in delta.items():
        if n:
            WRAPPERS[name].launches += n
