"""On-device image preprocessing: the resize as two matrix products
(counterpart of `clip_event_tpu/data/device_pipeline.py`).

For corpora whose images are decoded at a canonical raw size, or a host too
slow to resize, the whole CLIP transform runs on the card:

    uint8 [B, H0, W0, 3] → (M_v @ img @ M_hᵀ) → center crop → clip → normalize

The resampling matrices carry the exact PIL-bicubic taps
(`data.transform.resize_matrix`), so the output matches the host path up to
PIL's uint8 rounding between its two passes (≤ 1 count for ~99 % of pixels;
tests/test_transform.py::test_resize_matrix_matches_float_filter). The
products are fp32 (`torch.einsum`; TF32 where the process allows it, which
`platform.resolve_device` turns off). Only the matrix rows and columns of
the center crop are multiplied: each output pixel is the same sum of
products as in the uncropped resize.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from clip_event_tpu_torch.data.transform import CLIP_MEAN, CLIP_STD, resize_matrix


def _shortside_dims(h: int, w: int, size: int):
    if (h <= w and h == size) or (w <= h and w == size):
        return h, w
    if h < w:
        return size, int(size * w / h)
    return int(size * h / w), size


def preprocess_on_device(
    images: Union[np.ndarray, torch.Tensor], size: int = 224, device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """uint8/float [B, H0, W0, 3] (RGB) → float32 [B, size, size, 3]:
    short-side resize + center crop + CLIP normalization, on `device` (by
    default a tensor's own device; a numpy batch goes to the card)."""
    if isinstance(images, torch.Tensor):
        x = images if device is None else images.to(device)
    else:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device or "cuda")
    _, H0, W0, _ = x.shape
    out_h, out_w = _shortside_dims(H0, W0, size)
    # short-side resize guarantees out_h, out_w >= size (upscales small images)
    top = int(round((out_h - size) / 2.0))
    left = int(round((out_w - size) / 2.0))
    m_v = torch.tensor(resize_matrix(H0, out_h)[top : top + size], device=x.device)
    m_h = torch.tensor(resize_matrix(W0, out_w)[left : left + size], device=x.device)
    x = torch.einsum("oh,bhwc->bowc", m_v, x.float())
    x = torch.einsum("pw,bowc->bopc", m_h, x)
    x = x.clamp(0.0, 255.0) / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
