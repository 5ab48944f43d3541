"""Device selection for the port's entry points.

Every entry point takes a `device` argument that defaults to "cuda". With no
card present, asking for the card raises: an entry point never carries on on
the CPU unless the caller passed `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on the CPU"
        )
    return dev
