"""Bounding-box geometry (reference `utils_image.py`); own copy of
`clip_event_tpu/ops/bbox.py`, numpy only. All boxes are xyxy.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def normalize_bbox(bbox: Sequence[float], width: float, height: float) -> Tuple[float, ...]:
    x_min, y_min, x_max, y_max = bbox
    return (x_min / width, y_min / height, x_max / width, y_max / height)


def normalize_bbox_batch(bbox: np.ndarray, width: float, height: float) -> np.ndarray:
    out = np.array(bbox, dtype=np.float32, copy=True)
    out[:, 0] /= width
    out[:, 1] /= height
    out[:, 2] /= width
    out[:, 3] /= height
    return out


def patch_from_norm_bbox(bbox_norm: Sequence[float], patch_grid: int = 7) -> Tuple[int, int, int, int]:
    """Normalized box → inclusive-exclusive patch-grid window (floor/ceil,
    reference `utils_image.py:28-32`)."""
    x_min, y_min, x_max, y_max = bbox_norm
    return (
        math.floor(x_min * patch_grid),
        math.floor(y_min * patch_grid),
        math.ceil(x_max * patch_grid),
        math.ceil(y_max * patch_grid),
    )


def patch_from_norm_bbox_batch(bbox_norm: np.ndarray, patch_grid: int = 7) -> np.ndarray:
    """Vectorized (and fixed — the reference's batch variant has a y/x typo,
    `utils_image.py:39`)."""
    b = np.asarray(bbox_norm, np.float32) * patch_grid
    out = np.empty_like(b, dtype=np.int32)
    out[:, 0] = np.floor(b[:, 0])
    out[:, 1] = np.floor(b[:, 1])
    out[:, 2] = np.ceil(b[:, 2])
    out[:, 3] = np.ceil(b[:, 3])
    return out


def iou(box_a: Sequence[float], box_b: Sequence[float]) -> float:
    xa = max(box_a[0], box_b[0])
    ya = max(box_a[1], box_b[1])
    xb = min(box_a[2], box_b[2])
    yb = min(box_a[3], box_b[3])
    inter = max(0.0, xb - xa) * max(0.0, yb - ya)
    area_a = (box_a[2] - box_a[0]) * (box_a[3] - box_a[1])
    area_b = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    return inter / float(area_a + area_b - inter)


def iou_batch(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Elementwise IoU over identically-shaped [..., 4] xyxy box arrays."""
    xa = np.maximum(boxes_a[..., 0], boxes_b[..., 0])
    ya = np.maximum(boxes_a[..., 1], boxes_b[..., 1])
    xb = np.minimum(boxes_a[..., 2], boxes_b[..., 2])
    yb = np.minimum(boxes_a[..., 3], boxes_b[..., 3])
    inter = np.clip(xb - xa, 0, None) * np.clip(yb - ya, 0, None)
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]) * (boxes_a[..., 3] - boxes_a[..., 1])
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]) * (boxes_b[..., 3] - boxes_b[..., 1])
    denom = area_a + area_b - inter
    return np.where(denom > 0, inter / np.where(denom > 0, denom, 1.0), 0.0)


def grounding_correct(
    gold_boxes: Sequence[Sequence[float]],
    pred_boxes: Sequence[Sequence[float]],
    iou_threshold: float = 0.5,
) -> Tuple[int, float]:
    """1 if any predicted box overlaps any gold box at IoU ≥ threshold
    (reference `isCorrect`, `utils_image.py:65-73`)."""
    best = 0.0
    for p in pred_boxes:
        for g in gold_boxes:
            value = iou(p, g)
            best = max(best, value)
            if value >= iou_threshold:
                return 1, value
    return 0, best


def union_box(boxes) -> list:
    if len(boxes) == 0:
        return []
    boxes = np.atleast_2d(np.asarray(boxes, np.float32))
    mins = boxes.min(axis=0)
    maxes = boxes.max(axis=0)
    return [float(mins[0]), float(mins[1]), float(maxes[2]), float(maxes[3])]
