"""Shared zero-shot eval machinery, single device (counterpart of
`clip_event_tpu/evals/common.py`).

All evals reduce to: encode every image and every candidate text with the
normalized encoders in fixed-size batches (the last partial batch is padded
by repeating its last row), then score cosine logits on the host. Sharding
the data over processes or devices is not ported yet.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from clip_event_tpu_torch.models.clip import (
    CLIP,
    CLIPConfig,
    encode_image,
    encode_text,
    l2_normalize,
    tree_to,
)
from clip_event_tpu_torch.platform import resolve_device


def eval_loader(dataset, batch_size: int, num_workers: int = 8):
    """The canonical eval DataLoader: dataset order, no dropped tail."""
    from clip_event_tpu_torch.data.common import DataLoader

    return DataLoader(
        dataset, batch_size=min(batch_size, len(dataset)), shuffle=False, drop_last=False,
        num_workers=num_workers,
    )


class Encoders:
    """Fixed-batch wrappers around the normalized encoders on one device.

    `params` is a `CLIP` module or its param dict; it is moved to `device`
    (a no-op when it is there already). `compute_dtype` (default float32,
    the CLI's) is the activations' dtype; the weights are cast per matmul,
    as in the JAX package. `images` / `texts` take and return numpy;
    `encode_images` / `encode_texts` take and return device tensors."""

    def __init__(self, params, cfg: CLIPConfig, batch_size: int = 64,
                 compute_dtype=None, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(params, CLIP):
            params = params.params()
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype or torch.float32

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        return l2_normalize(
            encode_image(self.params, self.cfg, images, compute_dtype=self.compute_dtype)
        )

    def encode_texts(self, tokens: torch.Tensor) -> torch.Tensor:
        return l2_normalize(
            encode_text(self.params, self.cfg, tokens, compute_dtype=self.compute_dtype)
        )

    def _batched(self, fn, items: np.ndarray) -> np.ndarray:
        n = items.shape[0]
        out: List[np.ndarray] = []
        B = self.batch_size
        with torch.inference_mode():
            for start in range(0, n, B):
                chunk = items[start : start + B]
                pad = B - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                feats = fn(x).float().cpu().numpy()
                out.append(feats[: B - pad])
        return np.concatenate(out) if out else np.zeros((0,))

    def images(self, images: np.ndarray) -> np.ndarray:
        return self._batched(self.encode_images, images)

    def texts(self, tokens: np.ndarray) -> np.ndarray:
        return self._batched(self.encode_texts, tokens)


def collect_encoded(loader, enc: Encoders, encode: dict, keep: Tuple[str, ...] = ()):
    """One streaming pass over the loader: heavy fields are encoded
    batch-by-batch into [N, E] feature matrices, small fields and metas
    are concatenated as they are.

    `encode` maps field name → 'image' | 'text'. Returns (features dict,
    kept-tensors dict, metas list)."""
    feats = {f: [] for f in encode}
    kept = {f: [] for f in keep}
    metas = []
    for batch, meta in loader:
        for f, kind in encode.items():
            fn = enc.images if kind == "image" else enc.texts
            x = np.asarray(batch[f])
            feats[f].append(fn(x.reshape(-1, x.shape[-1]) if kind == "text" and x.ndim > 2 else x))
        for f in keep:
            kept[f].append(np.asarray(batch[f]))
        metas.extend(meta)
    out_f = {f: (np.concatenate(v) if v else np.zeros((0,), np.float32)) for f, v in feats.items()}
    out_k = {f: (np.concatenate(v) if v else np.zeros((0,), np.float32)) for f, v in kept.items()}
    return out_f, out_k, metas


def recall_at_k(ranks: np.ndarray, ks=(1, 5, 10)) -> dict:
    return {f"R@{k}": float((ranks < k).mean()) for k in ks}
