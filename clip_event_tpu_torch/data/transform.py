"""CLIP image preprocessing with bit-exact PIL parity.

The reference transform (CLIP's `clip.py:62-69`) is
`Resize(n, BICUBIC) → CenterCrop(n) → RGB → ToTensor → Normalize`. PIL's
resampler works in fixed-point integer arithmetic (8-bit channels filtered
with 22-bit coefficient precision, per pass), so a float implementation never
matches it bitwise. We emulate the fixed-point path exactly on the host
(`resize_bicubic_uint8`), and expose a float/matmul formulation of the same
filter (`resize_matrix`) for the on-device path, where the resize becomes
two products (`data/device_pipeline.py`).

Own copy of `clip_event_tpu/data/transform.py` (the port imports nothing
from the JAX package). Layout is NHWC, as there.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# CLIP normalization constants (reference clip.py:68)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

_PRECISION_BITS = 32 - 8 - 2  # PIL Resample.c fixed-point precision
_BICUBIC_A = -0.5
_BICUBIC_SUPPORT = 2.0


def _bicubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a=-0.5 (PIL/`BICUBIC`)."""
    a = _BICUBIC_A
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    near = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    far = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax < 1.0, near, np.where(ax < 2.0, far, 0.0))


@functools.lru_cache(maxsize=256)
def _precompute_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-output-pixel filter taps, PIL `precompute_coeffs` semantics.

    Returns (bounds[out,2] = (xmin, count), weights[out, ksize] float64, ksize).
    Weights are normalized to sum 1 and zero-padded to a common ksize.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1

    bounds = np.zeros((out_size, 2), dtype=np.int64)
    weights = np.zeros((out_size, ksize), dtype=np.float64)
    inv = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        n = xmax - xmin
        taps = _bicubic_kernel((np.arange(xmin, xmax) - center + 0.5) * inv)
        total = taps.sum()
        if total != 0.0:
            taps = taps / total
        bounds[xx] = (xmin, n)
        weights[xx, :n] = taps
    return bounds, weights, ksize


def _fixed_point_coeffs(weights: np.ndarray) -> np.ndarray:
    """PIL `normalize_coeffs_8bpc`: round float taps to 22-bit fixed point."""
    w = weights * (1 << _PRECISION_BITS)
    return np.where(w < 0, np.trunc(w - 0.5), np.trunc(w + 0.5)).astype(np.int64)


def _resample_axis_uint8(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One fixed-point resample pass over `axis` of a uint8 HWC array."""
    in_size = img.shape[axis]
    bounds, weights, ksize = _precompute_coeffs(in_size, out_size)
    coeffs = _fixed_point_coeffs(weights)

    # gather taps: index matrix [out, ksize], clipped (extra taps have weight 0)
    idx = bounds[:, 0:1] + np.arange(ksize)[None, :]
    idx = np.minimum(idx, in_size - 1)

    moved = np.moveaxis(img.astype(np.int64), axis, 0)  # [in, ...]
    gathered = moved[idx]  # [out, ksize, ...]
    extra_dims = (1,) * (gathered.ndim - 2)
    acc = (gathered * coeffs.reshape(coeffs.shape + extra_dims)).sum(axis=1)
    acc += 1 << (_PRECISION_BITS - 1)
    acc >>= _PRECISION_BITS
    out = np.clip(acc, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic_uint8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact PIL `Image.resize((w,h), BICUBIC)` on a uint8 HWC/HW array."""
    assert img.dtype == np.uint8
    if img.shape[1] != out_w:
        img = _resample_axis_uint8(img, out_w, axis=1)
    if img.shape[0] != out_h:
        img = _resample_axis_uint8(img, out_h, axis=0)
    return img


def resize_shortside(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision `Resize(int)`: scale the short side to `size`, keep aspect."""
    h, w = img.shape[:2]
    if (h <= w and h == size) or (w <= h and w == size):
        return img
    if h < w:
        out_h, out_w = size, int(size * w / h)
    else:
        out_h, out_w = int(size * h / w), size
    return resize_bicubic_uint8(img, out_h, out_w)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision `CenterCrop` (round-half-up offsets, pads if too small)."""
    h, w = img.shape[:2]
    if h < size or w < size:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        pads = [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)]
        pads += [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pads)
        h, w = img.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[top : top + size, left : left + size]


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC (RGB) → float32 HWC with CLIP mean/std."""
    x = img.astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def preprocess_image_u8(img, size: int = 224) -> np.ndarray:
    """CLIP preprocessing through the uint8 stages: PIL image or uint8 array
    → uint8 [size, size, 3] (resize + center crop, pre-normalize).

    This intermediate is bitwise-exact vs the reference transform, so it is
    the representation the offline image cache stores — `normalize` applied
    at read time reproduces `preprocess_image` exactly.
    """
    if not isinstance(img, np.ndarray):
        img = np.asarray(img.convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = resize_shortside(img, size)
    return center_crop(img, size)


def preprocess_image(img, size: int = 224) -> np.ndarray:
    """Full CLIP preprocessing: PIL image or uint8 array → float32 [size,size,3].

    Matches the reference transform bitwise through the uint8 stages. RGB
    conversion happens first (reference `dataset_voa.py:186` converts before
    transforming; for RGB JPEGs this is identical to converting after).
    """
    return normalize(preprocess_image_u8(img, size))


# --------------------------------------------------------------------------
# Device-side path: resize as two products (float32), same filter taps.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] float32 resampling matrix with PIL-bicubic taps.

    `out = M_v @ img @ M_h.T` reproduces the filter in float (no rounding
    between the passes), so the whole resize runs as two matrix products on
    the device. The cached array is shared: callers must not write to it.
    """
    bounds, weights, ksize = _precompute_coeffs(in_size, out_size)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        xmin, n = bounds[o]
        mat[o, xmin : xmin + n] = weights[o, :n]
    mat.flags.writeable = False
    return mat
