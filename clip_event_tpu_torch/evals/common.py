"""Shared zero-shot eval machinery (counterpart of
`clip_event_tpu/evals/common.py`).

All evals reduce to: encode every image and every candidate text with the
normalized encoders in fixed-size batches (the last partial batch is padded
by repeating its last row), then score cosine logits on the host.

Under data parallelism every rank encodes its rank-strided slice of the
dataset on its own device (`resolve_shard`, `eval_loader`), the per-rank
results are all-gathered and woven back into dataset order
(`merge_across_ranks`), and every rank computes the same full-set metrics
at 1/world of the encode cost (the reference's `gather_tensors` /
`all_gather` merging, `utils.py:94-206`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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


def resolve_shard(rank: Optional[int], world_size: Optional[int]) -> Tuple[int, int]:
    """The eval shard of this process: (rank, world_size) as given, or,
    when either is None, this process's place in the process group (every
    rank of a data-parallel run evaluates its own slice); (0, 1) without
    one."""
    if rank is None or world_size is None:
        from clip_event_tpu_torch.parallel.collectives import comm

        return comm.rank, comm.world_size
    return rank, world_size


def eval_loader(dataset, batch_size: int, num_workers: int = 8, rank: int = 0, world_size: int = 1):
    """The canonical eval DataLoader: dataset order, no dropped tail,
    rank-strided sharding."""
    from clip_event_tpu_torch.data.common import DataLoader

    return DataLoader(
        dataset, batch_size=min(batch_size, len(dataset)), shuffle=False, drop_last=False,
        num_workers=num_workers, rank=rank, world_size=world_size,
    )


def merge_across_ranks(n: int, world_size: int, *parts):
    """All-gather the per-rank strided results and weave them back into
    dataset order.

    Rank r's loader yields `padded[r::world_size]`, where `padded` wraps
    the first examples round to equalize the counts
    (`data.common.DataLoader._indices`); interleaving the gathered slices
    and trimming to `n` drops exactly that padding. Takes numpy arrays
    (stacked on axis 0) and lists (metas)."""
    if world_size <= 1:
        return parts if len(parts) > 1 else parts[0]
    from clip_event_tpu_torch.parallel.collectives import all_gather_objects

    gathered = all_gather_objects(parts)
    per_rank = -(-n // world_size)
    total = per_rank * world_size
    outs = []
    for j in range(len(parts)):
        ranks_j = [g[j] for g in gathered]
        if isinstance(ranks_j[0], np.ndarray):
            out = np.empty((total,) + ranks_j[0].shape[1:], ranks_j[0].dtype)
        else:
            out = [None] * total
        for r, p in enumerate(ranks_j):
            out[r::world_size] = p
        outs.append(out[:n])
    return tuple(outs) if len(outs) > 1 else outs[0]


def genuine_rows(rank: int, world_size: int, offset: int, b: int, n: int) -> np.ndarray:
    """Which of a rank's `b` loader rows from local position `offset` on
    are the dataset's own, not the loader's count-equalizing wrap-around
    (their global strided position is below `n`)."""
    return rank + (offset + np.arange(b)) * world_size < n


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


def macro_prf(gold: np.ndarray, pred: np.ndarray, num_classes: int) -> dict:
    """Macro precision/recall/F1 over the classes present in gold."""
    ps, rs, fs = [], [], []
    for c in range(num_classes):
        tp = int(((pred == c) & (gold == c)).sum())
        fp = int(((pred == c) & (gold != c)).sum())
        fn = int(((pred != c) & (gold == c)).sum())
        if tp + fn == 0:
            continue  # class absent from gold
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn)
        f = 2 * p * r / (p + r) if p + r else 0.0
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return {
        "macro_precision": float(np.mean(ps)) if ps else 0.0,
        "macro_recall": float(np.mean(rs)) if rs else 0.0,
        "macro_f1": float(np.mean(fs)) if fs else 0.0,
    }
