"""Shared data-layer infrastructure (the subset of
`clip_event_tpu/data/common.py` that zero-shot serving needs).

Datasets return per-example numpy dicts with static shapes, so batching is
a plain `np.stack`; a pool of host threads prepares the examples of the
next batches while the card encodes the current one.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from clip_event_tpu_torch.data.transform import preprocess_image

# batches whose examples are being built ahead of the consumer
_PREFETCH = 2


def load_image_file(path: str, size: int = 224) -> np.ndarray:
    """Decode + CLIP-preprocess one image file with PIL → float32
    [size, size, 3]. The native JPEG decoder and the offline image cache of
    the JAX package are not ported yet."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = 933120000
    with Image.open(path) as img:
        return preprocess_image(img, size)


def shorten_context(text: str, limit: int = 350) -> str:
    """Caption cleanup (reference `dataset_voa.py:88-91`)."""
    return text.replace("FILE - ", "")[:limit]


class ExampleDataset:
    """Base: subclasses implement __len__ and __getitem__ → (tensors, meta)."""

    def batch_extras(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Per-batch constant tensors (e.g. label layouts)."""
        return {}

    def finalize_batch(self, tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Batch-level reshapes (e.g. [B, D, 77] → [B·D, 77])."""
        return tensors


class DataLoader:
    """Deterministic loader: the dataset in order, in batches of
    `batch_size` (the last one partial), examples built by `num_workers`
    threads with the next batches in flight.

    Yields (batch_dict, meta_list): field → stacked numpy array, and the
    per-example non-tensor info (ids)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _collate(self, examples):
        tensors = {k: np.stack([ex[0][k] for ex in examples]) for k in examples[0][0]}
        tensors.update(self.dataset.batch_extras(len(examples)))
        return self.dataset.finalize_batch(tensors), [ex[1] for ex in examples]

    def __iter__(self) -> Iterator:
        bs = self.batch_size
        chunks = (range(b * bs, min((b + 1) * bs, len(self.dataset))) for b in range(len(self)))
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending: collections.deque = collections.deque()
            for chunk in chunks:
                pending.append([pool.submit(self.dataset.__getitem__, i) for i in chunk])
                if len(pending) > _PREFETCH:
                    yield self._collate([f.result() for f in pending.popleft()])
            while pending:
                yield self._collate([f.result() for f in pending.popleft()])
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
