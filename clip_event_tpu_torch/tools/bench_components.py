"""Component-level benchmark of the port: where a transformer stack's time
goes, and which variant wins (counterpart of the repo's
`tools/bench_components.py`; the sections that reach the LayerNorm kernels
and the megakernel).

    python -m clip_event_tpu_torch.tools.bench_components [ln] [megakernel] [--device cpu]

Sections:

  ln          the gradient of a 12-layer ViT-B/32 stack (text: 768 rows of
              77 tokens, W = 512, causal; vision: 256 rows of 50 tokens,
              W = 768), bf16 activations, every block recomputed in the
              backward pass, with the plain LayerNorm, with the fused
              LayerNorm kernels (K4), and with no LayerNorm at all (the
              ceiling a faster LayerNorm could reach)
  megakernel  the 12-layer forward of LayerNorm → QKV projection → attention
              core at the same shapes, bf16 weights, as the unfused chain
              (plain LayerNorm, `linear`, K1) and as the one-kernel fusion
              (K6)

On the card a row is the mean device time of `--steps` iterations between
CUDA events after a warm-up; on the CPU (a rehearsal of the path at a small
size, e.g. `--batch 2 --layers 1 --steps 1`) it is the host clock. Prints
one line per row, then one JSON line with all rows, the device and, on the
card, its name and power limit as `nvidia-smi` prints them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from clip_event_tpu_torch.config import model_config
from clip_event_tpu_torch.models import layers
from clip_event_tpu_torch.ops.attention import (
    fused_attention_qkv,
    fused_ln_qkv_attention,
    megakernel_supported,
)
from clip_event_tpu_torch.platform import resolve_device

B = 256
D = 3
STEPS = 10
SECTIONS = ("ln", "megakernel")


def tower_shapes(mcfg, batch: int, n_layers: Optional[int] = None):
    """(tower, layers, W, heads, S, rows, causal) of the two stacks."""
    return [
        ("text", n_layers or mcfg.transformer_layers, mcfg.transformer_width,
         mcfg.transformer_heads, mcfg.context_length, batch * D, True),
        ("vision", n_layers or mcfg.vision_layers, mcfg.vision_width, mcfg.vision_heads,
         mcfg.grid_size ** 2 + 1, batch, False),
    ]


def _time_ms(fn: Callable[[], None], steps: int, device: torch.device) -> float:
    """Mean time of fn() in ms after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / steps


def _ln_free_block(x, params, num_heads, attn_bias):
    """`residual_block` with both LayerNorms taken out."""
    x = x + layers.multi_head_attention(x, params["attn"], num_heads, attn_bias)
    h = layers.quick_gelu(layers.linear(x, params["mlp"]["fc_w"], params["mlp"]["fc_b"]))
    return x + layers.linear(h, params["mlp"]["proj_w"], params["mlp"]["proj_b"])


def _ln_free_stack(x, stacked, num_heads, attn_bias):
    for i in range(stacked["attn"]["qkv_w"].shape[0]):
        x = checkpoint(_ln_free_block, x, layers._layer(stacked, i), num_heads, attn_bias,
                       use_reentrant=False)
    return x


def _leaves(tree) -> list:
    return [t for v in tree.values() for t in (_leaves(v) if isinstance(v, dict) else [v])]


def bench_ln(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    """The stack gradient (value and every param's gradient of
    sum(out²)·1e-6) with the plain LayerNorm, the fused kernels, and no
    LayerNorm, both towers."""
    device = resolve_device(device)
    rows = []
    for tower, L, W, H, S, n, causal in tower_shapes(mcfg, batch, n_layers):
        gen = torch.Generator().manual_seed(0)
        stacked = layers.init_transformer(gen, L, W)
        stacked = {k: {kk: vv.to(device).requires_grad_(True) for kk, vv in v.items()}
                   for k, v in stacked.items()}
        x = torch.randn((n, S, W), generator=gen).to(device=device, dtype=torch.bfloat16)
        bias = layers.causal_mask(S, device=device) if causal else None
        leaves = _leaves(stacked)
        variants = (
            ("plain LN", lambda: layers.transformer(x, stacked, H, bias, remat=True, ln="xla")),
            ("fused LN kernels", lambda: layers.transformer(x, stacked, H, bias, remat=True, ln="pallas")),
            ("LN-free ceiling", lambda: _ln_free_stack(x, stacked, H, bias)),
        )
        for name, fwd in variants:
            def grad_step(_fwd=fwd):
                loss = (_fwd().float() ** 2).sum() * 1e-6
                torch.autograd.grad(loss, leaves, allow_unused=True)

            rows.append({"section": "ln", "tower": tower, "variant": name, "layers": L, "rows": n,
                         "S": S, "W": W, "ms_per_iter": _time_ms(grad_step, steps, device)})
    return rows


def bench_megakernel(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    """The L-layer forward of LayerNorm → QKV projection → attention core,
    unfused (plain LayerNorm, `linear`, K1) against the megakernel (K6),
    bf16 weights and activations, both towers."""
    device = resolve_device(device)
    rows = []
    for tower, L, W, H, S, n, causal in tower_shapes(mcfg, batch, n_layers):
        if not megakernel_supported(S, W, H):
            rows.append({"section": "megakernel", "tower": tower, "variant": "unsupported shape",
                         "S": S, "W": W, "H": H, "ms_per_iter": None})
            continue
        gen = torch.Generator().manual_seed(0)
        stacked = layers.init_transformer(gen, L, W)
        stacked = {k: {kk: vv.to(device=device, dtype=torch.bfloat16) for kk, vv in v.items()}
                   for k, v in stacked.items()}
        x = torch.randn((n, S, W), generator=gen).to(device=device, dtype=torch.bfloat16)
        bias = layers.causal_mask(S, device=device) if causal else None
        scale = (W // H) ** -0.5

        def unfused(h, lp):
            qkv = layers.linear(layers.layer_norm(h, lp["ln_1"]), lp["attn"]["qkv_w"], lp["attn"]["qkv_b"])
            return fused_attention_qkv(qkv, bias, H, scale)

        def mega(h, lp):
            return fused_ln_qkv_attention(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"],
                                          lp["attn"]["qkv_w"], lp["attn"]["qkv_b"], bias, H, scale)

        for name, layer in (("ln+qkv+core unfused", unfused), ("ln+qkv+core megakernel", mega)):
            def forward(_layer=layer):
                with torch.no_grad():
                    h = x
                    for i in range(L):
                        h = _layer(h, layers._layer(stacked, i))

            rows.append({"section": "megakernel", "tower": tower, "variant": name, "layers": L,
                         "rows": n, "S": S, "W": W, "H": H,
                         "ms_per_iter": _time_ms(forward, steps, device)})
    return rows


def format_row(row: dict) -> str:
    label = f"{row['tower']}: {row['variant']}"
    if row["ms_per_iter"] is None:
        return f"{label:<44s} skipped"
    unit = "ms/iter (stack grad)" if row["section"] == "ln" else f"ms/iter ({row['layers']}-layer fwd)"
    return f"{label:<44s} {row['ms_per_iter']:8.2f} {unit}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Component benchmark of the PyTorch port")
    parser.add_argument("sections", nargs="*", metavar="section",
                        help=f"any of {', '.join(SECTIONS)} (default: all)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--model", default="ViT-B/32",
                        help="a preset name or a JSON object of CLIPConfig fields")
    parser.add_argument("--batch", type=int, default=B, help="images (texts are 3 per image)")
    parser.add_argument("--layers", type=int, default=None, help="layers per stack (default: the model's)")
    parser.add_argument("--steps", type=int, default=STEPS)
    args = parser.parse_args(argv)
    unknown = [name for name in args.sections if name not in SECTIONS]
    if unknown:
        parser.error(f"unknown section(s) {unknown}; options: {list(SECTIONS)}")
    device = resolve_device(args.device)
    model = json.loads(args.model) if args.model.lstrip().startswith("{") else args.model
    mcfg = model_config({"model": model})
    benches = {"ln": bench_ln, "megakernel": bench_megakernel}
    rows = []
    for section in args.sections or SECTIONS:
        for row in benches[section](mcfg, args.batch, args.layers, args.steps, device):
            print(format_row(row), flush=True)
            rows.append(row)
    on_card = device.type == "cuda"
    smi = None
    if on_card:
        from clip_event_tpu_torch.bench import nvidia_smi

        smi = nvidia_smi()
    print(json.dumps({"rows": rows, "device": {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "nvidia_smi": smi}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
