"""Preset sweep of the port: train-step throughput of the zoo's models across
batch sizes and remat policies, in one process (counterpart of the repo's
`tools/bench_presets.py`).

    python -m clip_event_tpu_torch.tools.bench_presets [ENTRY ...] [--device cpu]
    python -m clip_event_tpu_torch.tools.bench_presets --fast

An entry is MODEL:BATCH:REMAT. MODEL is a preset name (ViT-B/32, ViT-B/16,
ViT-L/14, RN50, RN101, RN50x4) or a JSON object of `CLIPConfig` fields (a
small model, for a rehearsal on the CPU); BATCH is images a step (3 texts
an image); REMAT is 0 (off), 1 (full) or a policy name (attn, dots,
dots_nobatch). With no entry the sweep runs `DEFAULT_GRID`, the JAX
tool's 15 entries.

Each entry times the bench entry point's step (`clip_event_tpu_torch.bench.run`)
on one device, with no mesh: N(0, 1) float32 images (the JAX tool's),
random token rows with EOT last, the "ce" layout, bf16, Adam at lr 1e-6,
the attention kernels; `--steps` (10) steps a call through
`make_multi_step` (on the card a CUDA graph of the step, replayed), one
warm-up call, then `--calls` (3) timed calls on the host's clock, stopped
by a fetch of the last loss. An entry that raises prints FAILED with the
error's type and first line, and the sweep goes on.

`--fast` (the JAX tool's BENCH_FAST=1) runs `FAST_GRID` (or the entries
given) with one timed call an entry and holds each entry's pairs/s against
its figure in `FAST_GRID`: below (1 - FAST_TOLERANCE) of it, or missing,
is "regressed". The figures are the card's own, named beside them; none is
a TPU figure.

Prints one line an entry, then one JSON line: the rows and the device (on
the card its name and power limit as `nvidia-smi` prints them), and with
`--fast` the verdict (`fast_presets`, `expected`, `tolerance`,
`regressed`, `ok`). On the CPU the times are a rehearsal of the path.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Tuple

import torch

from clip_event_tpu_torch import bench
from clip_event_tpu_torch.platform import resolve_device

DEFAULT_GRID = [
    # ViT-L/14: the remat policies at W = 1024, and the batch's memory ceiling
    "ViT-L/14:64:1", "ViT-L/14:64:attn", "ViT-L/14:64:dots_nobatch",
    "ViT-L/14:96:1", "ViT-L/14:128:1",
    # ViT-B/16: batch and policy
    "ViT-B/16:96:1", "ViT-B/16:128:1", "ViT-B/16:160:1", "ViT-B/16:96:attn",
    # RN101 / RN50x4
    "RN101:64:1", "RN101:96:1", "RN101:128:1",
    "RN50x4:32:1", "RN50x4:64:1", "RN50x4:96:1",
]

# --fast: one call an entry at each preset's chosen config, against the
# pairs/s of one `--fast` run on an NVIDIA H100 80GB HBM3, power limit
# 700.00 W (nvidia-smi; torch 2.11.0+cu128)
FAST_GRID = {
    "ViT-B/32:384:1": 3483.9,
    "ViT-B/16:96:attn": 1755.2,
    "ViT-L/14:64:attn": 565.3,
    "RN50:128:1": 2534.7,
    "RN101:128:attn": 2172.5,
    "RN50x4:128:1": 1408.7,
}
# the regression alarm (the JAX tool's)
FAST_TOLERANCE = 0.05

STEPS_PER_CALL = 10
MEASURE_CALLS = 3


def parse_entry(entry: str) -> Tuple[object, int, str]:
    """MODEL:BATCH:REMAT → (a preset name or a dict of CLIPConfig fields,
    images, remat as given). Raises ValueError on a malformed entry."""
    try:
        model, batch, remat = entry.rsplit(":", 2)
        batch = int(batch)
    except ValueError:
        raise ValueError(f"entry {entry!r}: expected MODEL:BATCH:REMAT") from None
    if remat not in bench.REMAT_CHOICES:
        raise ValueError(f"entry {entry!r}: remat {remat!r}; options: {bench.REMAT_CHOICES}")
    return (json.loads(model) if model.lstrip().startswith("{") else model), batch, remat


def bench_one(model, batch: int, remat: str, steps: int = STEPS_PER_CALL, calls: int = MEASURE_CALLS,
              device="cuda") -> dict:
    """One entry's step, timed (`bench.run` with float32 images); its
    result line."""
    return bench.run(model, batch, "xla", bench.remat_setting(remat), 0, steps, 1, device, "float32", calls)


def label(model, batch: int, remat: str) -> str:
    name = model if isinstance(model, str) else "custom"
    return f"{name:<9s} B={batch:<4d} remat={remat}"


def sweep(grid: List[str], steps: int, calls: int, device) -> List[dict]:
    """A row an entry: its step ms, pairs/s, launches a step and last loss,
    or the error it raised."""
    rows = []
    for entry in grid:
        model, batch, remat = parse_entry(entry)
        row = {"entry": entry, "model": model if isinstance(model, str) else "custom", "batch": batch,
               "remat": remat}
        try:
            result = bench_one(model, batch, remat, steps, calls, device)
            row.update(step_ms=result["step_ms"], pairs_per_s=result["value"], loss=result["loss"],
                       steps_per_call=steps, calls=calls, launches_per_step=result["launches_per_step"])
            print(f"{label(model, batch, remat):<34s} {row['step_ms']:8.1f} ms/step  "
                  f"{row['pairs_per_s']:8.0f} pairs/s", flush=True)
        except Exception as e:  # noqa: BLE001 (any error, as the JAX tool catches)
            row["error"] = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:120]}"
            print(f"{label(model, batch, remat):<34s} FAILED: {row['error']}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
    return rows


def verdict(rows: List[dict], expected: dict = None, tolerance: float = FAST_TOLERANCE) -> dict:
    """The `--fast` line: each entry's pairs/s against `expected`
    (`FAST_GRID`); missing or below (1 - tolerance) of its figure is
    regressed."""
    expected = FAST_GRID if expected is None else expected
    results = {r["entry"]: r["pairs_per_s"] for r in rows if "pairs_per_s" in r}
    regressed = {e: {"got": results.get(e), "expected": v} for e, v in expected.items()
                 if e not in results or results[e] < v * (1 - tolerance)}
    return {"fast_presets": {e: round(v, 1) for e, v in results.items()}, "expected": expected,
            "tolerance": tolerance, "regressed": regressed, "ok": not regressed}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Preset sweep of the PyTorch port's train step")
    parser.add_argument("entries", nargs="*", metavar="MODEL:BATCH:REMAT",
                        help="default: DEFAULT_GRID (FAST_GRID with --fast)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--fast", action="store_true",
                        help="FAST_GRID, one timed call an entry, and the regression verdict")
    parser.add_argument("--steps", type=int, default=STEPS_PER_CALL, help="train steps a call")
    parser.add_argument("--calls", type=int, default=None,
                        help=f"timed calls (default {MEASURE_CALLS}; 1 with --fast)")
    args = parser.parse_args(argv)
    grid = args.entries or (list(FAST_GRID) if args.fast else DEFAULT_GRID)
    for entry in grid:
        try:
            parse_entry(entry)
        except ValueError as e:
            parser.error(str(e))
    device = resolve_device(args.device)
    calls = args.calls or (1 if args.fast else MEASURE_CALLS)
    rows = sweep(grid, args.steps, calls, device)
    on_card = device.type == "cuda"
    line = {"rows": rows, "device": {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "nvidia_smi": bench.nvidia_smi() if on_card else None}}
    if args.fast:
        line = {**verdict(rows), **line}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
