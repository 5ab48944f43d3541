"""Device selection for the port's entry points.

Every entry point takes a `device` argument that defaults to "cuda". With no
card present, asking for the card raises: an entry point never carries on on
the CPU unless the caller passed `device="cpu"`.

Resolving a CUDA device also sets the package's one precision rule for
PyTorch's own kernels on the card: fp32 stays fp32. TF32 is switched off
for cuBLAS (PyTorch's default already) and for cuDNN (on by default), so
an fp32 ResNet tower's convolutions compute the same function in every
CLI, in the train loop and in `chip_smoke.py`.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
