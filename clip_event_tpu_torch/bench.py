"""Headline benchmark of the port: contrastive training throughput of one
train step on one device (counterpart of the repo's `bench.py`).

    python -m clip_event_tpu_torch.bench [--device cpu]

Measures the train step (forward of both towers + contrastive loss +
backward + clipped Adam) at the reference workload shape: D = 3
descriptions per image (1 positive + 2 hard negatives), uint8 images at the
model's resolution normalized on the device, 77-token texts, bf16 compute,
full remat, Adam at lr 1e-6; batch 384 (ViT-B/32), 96 (ViT-B/16) or 64
(ViT-L/14) images. The batch is made once from seed 0 and stays on the
device; after the warm-up steps the timed steps run back to back and the
clock stops after a device synchronize. It reports contrastive pairs/s per
chip, pairs = images × descriptions scored.

The JAX bench runs ViT-B/16 and ViT-L/14 with the selective "attn" remat
policy. The port has full remat only, so those presets run full remat and
the output says so.

Environment, as in the JAX bench: `BENCH_MODEL` (a preset name, or a JSON
object with `CLIPConfig`'s fields for a small model), `BENCH_BATCH`,
`BENCH_LN=pallas` (the fused LayerNorm kernels in every residual block),
`BENCH_REMAT` (`0` turns remat off), `BENCH_CONTEXT_CAP`; and
`BENCH_STEPS`, `BENCH_WARMUP`. The flags of the same names override them.

Prints exactly one JSON line. On the card the metric is
`contrastive_pairs_per_sec_per_chip` and the line carries the card's name
and power limit as `nvidia-smi` prints them; it is compared with no figure
of another device. A run on the CPU is a rehearsal of the path: its metric
is named `contrastive_pairs_per_sec_cpu`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from clip_event_tpu_torch.config import model_config
from clip_event_tpu_torch.data.labels import build_label_layout
from clip_event_tpu_torch.engine.optim import build_optimizer, build_schedule
from clip_event_tpu_torch.engine.train_step import create_train_state, make_train_step
from clip_event_tpu_torch.models import layers
from clip_event_tpu_torch.models.clip import init_params
from clip_event_tpu_torch.ops import attention, ln
from clip_event_tpu_torch.platform import resolve_device

DEFAULT_BATCH = {"ViT-B/32": 384, "ViT-B/16": 96, "ViT-L/14": 64}
# presets the JAX bench runs with the "attn" remat policy
ATTN_REMAT_PRESETS = ("ViT-B/16", "ViT-L/14")
NUM_POS, NUM_NEG = 1, 2
WARMUP_STEPS, MEASURE_STEPS = 3, 10

_COUNTERS = {
    "attention_fwd": attention.fused_attention_qkv,
    "attention_bwd": attention.fused_attention_qkv_bwd,
    "attention_hg_fwd": attention.fused_attention_qkv_headgrid,
    "attention_hg_bwd": attention.fused_attention_qkv_headgrid_bwd,
    "layer_norm": ln.fused_layer_norm,
    "add_layer_norm": ln.fused_add_layer_norm,
    "layer_norm_bwd": ln.fused_layer_norm_bwd,
}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_batch(mcfg, batch: int, seq: int, device) -> dict:
    """The bench workload's batch from seed 0, on `device`: uint8 images,
    [B·D, seq] token rows (random ids, EOT in the last slot) and the label
    layout."""
    rng = np.random.default_rng(0)
    D = NUM_POS + NUM_NEG
    res = mcfg.image_resolution
    layout = build_label_layout(batch, NUM_POS, NUM_NEG)
    text = rng.integers(1, min(49000, mcfg.vocab_size - 1), size=(batch * D, seq)).astype(np.int32)
    text[:, -1] = mcfg.vocab_size - 1
    arrays = {
        "image": rng.integers(0, 256, size=(batch, res, res, 3), dtype=np.uint8),
        "text": text,
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def run(model="ViT-B/32", batch=None, ln_impl="xla", remat=True, context_cap=0,
        steps=MEASURE_STEPS, warmup=WARMUP_STEPS, device="cuda") -> dict:
    """Time the train step and return the result line as a dict."""
    device = resolve_device(device)
    mcfg = model_config({"model": model})
    name = model if isinstance(model, str) else "custom"
    batch = int(batch or DEFAULT_BATCH.get(name, 64))
    seq = int(context_cap) or mcfg.context_length
    D = NUM_POS + NUM_NEG

    params = init_params(torch.Generator().manual_seed(0), mcfg, device)
    data = bench_batch(mcfg, batch, seq, device)
    optimizer = build_optimizer("adam", build_schedule("none", 1e-6, 30))
    state = create_train_state(params, optimizer)
    step = make_train_step(mcfg, optimizer, loss_type="ce", overbatch=True,
                           compute_dtype=torch.bfloat16, remat=remat)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with layers.ln_impl(ln_impl):
        for _ in range(warmup):
            state, metrics = step(state, data)
        sync()
        for fn in _COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, data)
        sync()
        dt = (time.perf_counter() - t0) / steps
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError("non-finite loss in benchmark")

    on_card = device.type == "cuda"
    out = {
        "metric": "contrastive_pairs_per_sec_per_chip" if on_card else "contrastive_pairs_per_sec_cpu",
        "value": batch * D / dt,
        "unit": "pairs/s/chip" if on_card else "pairs/s",
        "model": name, "batch_images": batch, "descriptions_per_image": D, "tokens": seq,
        "compute_dtype": "bfloat16", "remat": "full" if remat else "off", "ln": ln_impl,
        "optimizer": "adam", "steps": steps, "warmup_steps": warmup, "step_ms": dt * 1e3,
        "loss": loss,
        "launches_per_step": {k: fn.launches // steps for k, fn in _COUNTERS.items()},
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "nvidia_smi": nvidia_smi() if on_card else None,
        },
    }
    if name in ATTN_REMAT_PRESETS and remat:
        out["remat_note"] = ("full remat; the JAX bench runs this preset with the 'attn' "
                             "policy, which is not ported")
    return out


def main(argv=None) -> int:
    env = os.environ
    parser = argparse.ArgumentParser(description="Train-step throughput of the PyTorch port")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--model", default=env.get("BENCH_MODEL", "ViT-B/32"),
                        help="a preset name or a JSON object of CLIPConfig fields")
    parser.add_argument("--batch", type=int, default=int(env.get("BENCH_BATCH", 0)) or None)
    parser.add_argument("--ln", default=env.get("BENCH_LN", "xla"), choices=layers.LN_IMPLS)
    parser.add_argument("--remat", default=env.get("BENCH_REMAT", "1"), choices=("0", "1"))
    parser.add_argument("--context-cap", type=int, default=int(env.get("BENCH_CONTEXT_CAP", 0)))
    parser.add_argument("--steps", type=int, default=int(env.get("BENCH_STEPS", MEASURE_STEPS)))
    parser.add_argument("--warmup", type=int, default=int(env.get("BENCH_WARMUP", WARMUP_STEPS)))
    args = parser.parse_args(argv)
    model = json.loads(args.model) if args.model.lstrip().startswith("{") else args.model
    result = run(model, args.batch, args.ln, args.remat == "1", args.context_cap,
                 args.steps, args.warmup, args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
