"""Headline benchmark of the port: contrastive training throughput of one
train step on one device (counterpart of the repo's `bench.py`).

    python -m clip_event_tpu_torch.bench [--device cpu]

Measures the train step (forward of both towers + contrastive loss +
backward + clipped Adam) at the reference workload shape: D = 3
descriptions per image (1 positive + 2 hard negatives), uint8 images at the
model's resolution normalized on the device, 77-token texts, bf16 compute,
Adam at lr 1e-6; batch 384 (ViT-B/32), 96 (ViT-B/16) or 64 (ViT-L/14)
images, and the JAX bench's remat policy for each preset: full remat at
ViT-B/32, "attn" at ViT-B/16 and ViT-L/14 (`DEFAULT_REMAT`, the JAX
bench's table). The protocol is the JAX bench's: 10 steps a call through
`make_multi_step`'s `many_fixed` (on the card a CUDA graph of the step,
replayed 10 times), one warm-up call, then 3 timed calls back to back;
the clock stops at a float fetch of the last call's last loss. The batch
is made once from seed 0 and stays on the device. It reports contrastive
pairs/s per chip, pairs = images × descriptions scored.

`--images uint8` (the default) feeds the train loop's input
(`device_normalize: true`: uint8 pixels, normalized on the device);
`--images float32` feeds the JAX bench's input, N(0, 1) float32 images that
skip the normalize and move four times the bytes. The line says which.

Environment, as in the JAX bench: `BENCH_MODEL` (a preset name, or a JSON
object with `CLIPConfig`'s fields for a small model), `BENCH_BATCH`,
`BENCH_LN=pallas` (the fused LayerNorm kernels in every residual block),
`BENCH_REMAT` (`0` off, `1` full, or a policy name: "full", "dots",
"dots_nobatch", "attn"), `BENCH_CONTEXT_CAP`; and `BENCH_STEPS` (steps a
call), `BENCH_CALLS` (timed calls), `BENCH_WARMUP` (warm-up calls),
`BENCH_IMAGES`. The flags of the same names override them.

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
from clip_event_tpu_torch.engine.train_step import create_train_state, make_multi_step
from clip_event_tpu_torch.models import layers
from clip_event_tpu_torch.models.clip import init_params
from clip_event_tpu_torch.ops import counters
from clip_event_tpu_torch.platform import resolve_device

DEFAULT_BATCH = {"ViT-B/32": 384, "ViT-B/16": 96, "ViT-L/14": 64}
# the JAX bench's remat policy by preset (`bench.py:41-48`): "1" is full
DEFAULT_REMAT = {"ViT-B/32": "1", "ViT-B/16": "attn", "ViT-L/14": "attn"}
REMAT_CHOICES = ("0", "1") + layers.REMAT_POLICIES
NUM_POS, NUM_NEG = 1, 2
STEPS_PER_CALL, MEASURE_CALLS, WARMUP_CALLS = 10, 3, 1
IMAGE_INPUTS = ("uint8", "float32")
# the train step's kernels, whose launches a step the line reports
_COUNTED = ("attention_fwd", "attention_bwd", "attention_hg_fwd", "attention_hg_bwd",
            "layer_norm", "add_layer_norm", "layer_norm_bwd")


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_batch(mcfg, batch: int, seq: int, device, images: str = "uint8") -> dict:
    """The bench workload's batch from seed 0, on `device`: uint8 images
    (or, for `images="float32"`, the JAX bench's N(0, 1) float32 images),
    [B·D, seq] token rows (random ids, EOT in the last slot) and the label
    layout."""
    if images not in IMAGE_INPUTS:
        raise ValueError(f"images {images!r}; options: {IMAGE_INPUTS}")
    rng = np.random.default_rng(0)
    D = NUM_POS + NUM_NEG
    res = mcfg.image_resolution
    layout = build_label_layout(batch, NUM_POS, NUM_NEG)
    text = rng.integers(1, min(49000, mcfg.vocab_size - 1), size=(batch * D, seq)).astype(np.int32)
    text[:, -1] = mcfg.vocab_size - 1
    if images == "uint8":
        image = rng.integers(0, 256, size=(batch, res, res, 3), dtype=np.uint8)
    else:
        image = rng.normal(size=(batch, res, res, 3)).astype(np.float32)
    arrays = {
        "image": image,
        "text": text,
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def remat_setting(value: str):
    """A `--remat` / `BENCH_REMAT` value as the train step takes it: "0"
    False, "1" True (full), a policy name as it is."""
    if value not in REMAT_CHOICES:
        raise ValueError(f"remat {value!r}; options: {REMAT_CHOICES}")
    return {"0": False, "1": True}.get(value, value)


def run(model="ViT-B/32", batch=None, ln_impl="xla", remat=None, context_cap=0,
        steps=STEPS_PER_CALL, warmup=WARMUP_CALLS, device="cuda", images="uint8",
        calls=MEASURE_CALLS) -> dict:
    """Time `calls` dispatches of `steps` train steps each (after `warmup`
    dispatches) and return the result line as a dict. `remat` None takes
    the preset's `DEFAULT_REMAT` ("1" for a custom model)."""
    device = resolve_device(device)
    mcfg = model_config({"model": model})
    name = model if isinstance(model, str) else "custom"
    batch = int(batch or DEFAULT_BATCH.get(name, 64))
    seq = int(context_cap) or mcfg.context_length
    D = NUM_POS + NUM_NEG
    if remat is None:
        remat = remat_setting(DEFAULT_REMAT.get(name, "1"))
    policy = layers.remat_policy(remat) or "off"

    params = init_params(torch.Generator().manual_seed(0), mcfg, device)
    data = bench_batch(mcfg, batch, seq, device, images)
    optimizer = build_optimizer("adam", build_schedule("none", 1e-6, 30))
    state = create_train_state(params, optimizer)
    _, run_k = make_multi_step(mcfg, optimizer, steps, loss_type="ce", overbatch=True,
                               compute_dtype=torch.bfloat16, remat=remat)

    with layers.ln_impl(ln_impl):
        for _ in range(warmup):
            state, metrics = run_k(state, data)
            float(metrics["loss"][-1])
        start = counters.snapshot()
        t0 = time.perf_counter()
        for _ in range(calls):
            state, metrics = run_k(state, data)
        loss = float(metrics["loss"][-1])  # the sync: a host fetch of the last loss
        dt = (time.perf_counter() - t0) / (calls * steps)
        end = counters.snapshot()
    if not math.isfinite(loss):
        raise RuntimeError("non-finite loss in benchmark")

    on_card = device.type == "cuda"
    return {
        "metric": "contrastive_pairs_per_sec_per_chip" if on_card else "contrastive_pairs_per_sec_cpu",
        "value": batch * D / dt,
        "unit": "pairs/s/chip" if on_card else "pairs/s",
        "model": name, "batch_images": batch, "descriptions_per_image": D, "tokens": seq,
        "images": images, "compute_dtype": "bfloat16", "remat": policy, "ln": ln_impl,
        "optimizer": "adam", "steps_per_call": steps, "calls": calls, "warmup_calls": warmup,
        "steps": calls * steps, "warmup_steps": warmup * steps, "step_ms": dt * 1e3,
        "loss": loss,
        "launches_per_step": {k: (end[k] - start[k]) // (calls * steps) for k in _COUNTED},
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "nvidia_smi": nvidia_smi() if on_card else None,
        },
    }


def main(argv=None) -> int:
    env = os.environ
    parser = argparse.ArgumentParser(description="Train-step throughput of the PyTorch port")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--model", default=env.get("BENCH_MODEL", "ViT-B/32"),
                        help="a preset name or a JSON object of CLIPConfig fields")
    parser.add_argument("--batch", type=int, default=int(env.get("BENCH_BATCH", 0)) or None)
    parser.add_argument("--ln", default=env.get("BENCH_LN", "xla"), choices=layers.LN_IMPLS)
    parser.add_argument("--remat", default=env.get("BENCH_REMAT"), choices=REMAT_CHOICES,
                        help="0, 1 (full) or a policy name; default: the preset's DEFAULT_REMAT")
    parser.add_argument("--context-cap", type=int, default=int(env.get("BENCH_CONTEXT_CAP", 0)))
    parser.add_argument("--steps", type=int, default=int(env.get("BENCH_STEPS", STEPS_PER_CALL)),
                        help="train steps a call (one dispatch)")
    parser.add_argument("--calls", type=int, default=int(env.get("BENCH_CALLS", MEASURE_CALLS)),
                        help="timed calls")
    parser.add_argument("--warmup", type=int, default=int(env.get("BENCH_WARMUP", WARMUP_CALLS)),
                        help="warm-up calls")
    parser.add_argument("--images", default=env.get("BENCH_IMAGES", "uint8"), choices=IMAGE_INPUTS,
                        help="uint8 pixels normalized on the device, or the JAX bench's float32")
    args = parser.parse_args(argv)
    model = json.loads(args.model) if args.model.lstrip().startswith("{") else args.model
    remat = None if args.remat is None else remat_setting(args.remat)
    result = run(model, args.batch, args.ln, remat, args.context_cap,
                 args.steps, args.warmup, args.device, args.images, args.calls)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
