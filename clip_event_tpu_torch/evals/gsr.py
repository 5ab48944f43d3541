"""Grid-feature grounding helpers of the GSR eval (counterpart of the first
part of `clip_event_tpu/evals/gsr.py`): the M2E2 eval grounds argument
roles with them. A role description's embedding against the ViT grid-token
embeddings gives a heat map over the patch grid; the union box of its
top-k cells is the predicted argument box. `evaluate_gsr` itself waits
for the multiattention module.
"""

from __future__ import annotations

import numpy as np
import torch

from clip_event_tpu_torch.models import clip as clip_model


def _grid_features_fn(cfg, compute_dtype=None):
    """fn(params, images numpy [B, H, W, 3]) → l2-normalized grid features
    [B, grid²+1, E] (CLS first) as numpy, encoded on the params' device."""
    dtype = compute_dtype or torch.float32

    def fn(params, images):
        device = params["logit_scale"].device
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            feats = clip_model.encode_image(params, cfg, x, use_grid=True, compute_dtype=dtype)
            return clip_model.l2_normalize(feats).float().cpu().numpy()

    return fn


def window_boxes(heat: np.ndarray, grid: int, topk: int = 1) -> np.ndarray:
    """Vectorized: [..., G²] heat maps → [..., 4] union bbox of the top-k
    grid cells, in normalized coords."""
    k = min(topk, heat.shape[-1])
    top = np.argpartition(-heat, k - 1, axis=-1)[..., :k]
    rows, cols = top // grid, top % grid
    return np.stack(
        [
            cols.min(axis=-1) / grid,
            rows.min(axis=-1) / grid,
            (cols.max(axis=-1) + 1) / grid,
            (rows.max(axis=-1) + 1) / grid,
        ],
        axis=-1,
    ).astype(np.float32)


def patch_window_bbox(heat: np.ndarray, grid: int, topk: int = 1) -> list:
    """Single-heat-map convenience wrapper around `window_boxes`."""
    return list(window_boxes(heat.reshape(-1), grid, topk))
