"""Device-side batch prefetching (counterpart of
`clip_event_tpu/data/prefetch.py`, single device).

Wraps a host DataLoader so the next `depth` batches are already on the card
while the current step runs: a background thread takes each numpy batch,
copies it into pinned host memory and issues the host→device copies with
`non_blocking=True` on a side CUDA stream. The consumer's stream waits on
an event recorded after those copies, so a step never reads a batch before
it has landed, and never waits for the copies of the batches behind it.
On the CPU the batch is just turned into tensors.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator

import numpy as np
import torch

_SENTINEL = object()


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_prefetch(loader, device, depth: int = 2) -> Iterator:
    """Yields (device_batch, meta) with up to `depth` batches in flight, in
    loader order. Loader exceptions re-raise on the consumer thread;
    closing the generator (early `break`) stops the worker."""
    device = torch.device(device)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(int(depth), 1))
    stop = threading.Event()
    err: list = []
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for batch, meta in loader:
                if side is None:
                    item = (_to_device(batch, device), meta, None)
                else:
                    with torch.cuda.stream(side):
                        tensors = _to_device(batch, device)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    item = (tensors, meta, ready)
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            tensors, meta, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for v in tensors.values():
                    # the caching allocator must not hand these blocks out
                    # again before the consumer's stream is done with them
                    v.record_stream(current)
            yield tensors, meta
    finally:
        stop.set()
        t.join(timeout=10)
