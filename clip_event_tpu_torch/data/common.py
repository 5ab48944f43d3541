"""Shared data-layer infrastructure (counterpart of
`clip_event_tpu/data/common.py`).

Datasets return per-example numpy dicts with static shapes, so batching is
a plain `np.stack`; a pool of host threads prepares the examples of the
next batches while the card runs the current one.
"""

from __future__ import annotations

import collections
import csv
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from operator import itemgetter
from typing import Dict, Iterator, List, Sequence

import numpy as np

from clip_event_tpu_torch.data.transform import preprocess_image, preprocess_image_u8


def load_image_file(path: str, size: int = 224, raw: bool = False) -> np.ndarray:
    """Decode + CLIP-preprocess one image file → float32 [size, size, 3].

    Checks the offline preprocessed cache first (`data.cache`, bit-exact
    uint8 rows, activated explicitly or through CLIP_EVENT_IMAGE_CACHE); on
    a miss uses the native C++ path (`data.native`: libjpeg + fixed-point
    bicubic, GIL-free) for a JPEG when the library builds; else PIL + the
    pure-Python bit-exact transform. CLIP_EVENT_NATIVE=0 turns the native
    path off.

    `raw=True` returns the pre-normalize uint8 [size, size, 3] stage (the
    exact PIL intermediate the cache stores; the model normalizes uint8
    inputs on the device, `models/clip.py::encode_image`): a cache hit is
    a bare copy of a row, and a miss takes the pure-Python u8 path (exact,
    slower), as in the JAX package.
    """
    from clip_event_tpu_torch.data import cache as image_cache

    cached = image_cache.active_cache()
    if cached is not None:
        hit = cached.get_u8(path, size) if raw else cached.get(path, size)
        if hit is not None:
            return hit

    if not raw and os.environ.get("CLIP_EVENT_NATIVE", "1") != "0" and path.lower().endswith(
        (".jpg", ".jpeg")
    ):
        from clip_event_tpu_torch.data import native

        out = native.preprocess_jpeg_file(path, size)
        if out is not None:
            return out

    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = 933120000
    with Image.open(path) as img:
        return preprocess_image_u8(img, size) if raw else preprocess_image(img, size)


def load_object_crops(
    path: str,
    detections: Sequence[dict],
    allowed_labels: Dict[str, str],
    threshold: float = 0.2,
    topk: int = 50,
    size: int = 224,
):
    """Whole image at slot 0 + CLIP-preprocessed float32 crops of its
    detections (reference `load_img_object`, `dataset_voa.py:181-248`):
    detections score-sorted ascending, filtered to the allowed-label
    ontology and the score threshold, capped at `topk`. Returns (crops
    [n, size, size, 3], ids, label names) with n <= topk + 1."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = 933120000

    with Image.open(path) as img:
        img = img.convert("RGB")
        crops = [preprocess_image(img, size)]
        ids = ["0_0_0_0"]
        labels = ["UNKNOWN"]
        count = 1
        for det in sorted(detections, key=itemgetter("score")):
            if count > topk:
                break
            if det["label"] not in allowed_labels or det["score"] < threshold:
                continue
            bbox = det["bbox"]
            try:
                patch = img.crop(bbox)
                crops.append(preprocess_image(patch, size))
            # a box PIL refuses (right < left), an empty crop, a truncated
            # file: the detection is skipped, as in the reference
            except (ValueError, ZeroDivisionError, OSError):
                continue
            ids.append("%d_%d_%d_%d" % tuple(int(v) for v in bbox))
            labels.append(allowed_labels[det["label"]])
            count += 1
    return np.stack(crops), ids, labels


def load_object_label_map(class_map_csv: str) -> Dict[str, str]:
    """Open-Images class map: rows `label_id,name,is_arg_type`; keep rows
    flagged '1' (reference `get_object_labels`, `dataset_voa.py:168-179`)."""
    out = {}
    with open(class_map_csv, newline="") as fh:
        for row in csv.reader(fh):
            if len(row) >= 3 and row[2] == "1":
                out[row[0]] = row[1]
    return out


def load_detection_pickles(paths: Sequence[str]) -> dict:
    """Merge the object-detection pickles {image_id: [{label, bbox, score}]}
    (files this project's detection step wrote)."""
    results: dict = {}
    for p in paths:
        with open(p, "rb") as fh:
            results.update(pickle.load(fh))
    return results


def pad_stack(
    arrays: List[np.ndarray], cap: int, pad_shape=None, dtype=np.float32
) -> np.ndarray:
    """Stack a variable-length list of same-shape items into [cap, ...],
    zero-padding the missing slots. `pad_shape`/`dtype` describe one item
    when the list may be empty."""
    if arrays:
        tail = arrays[0].shape
        dtype = arrays[0].dtype
    else:
        tail = tuple(pad_shape or ())
    out = np.zeros((cap,) + tuple(tail), dtype=dtype)
    for i, a in enumerate(arrays[:cap]):
        out[i] = a
    return out


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
    """Rank-strided, multi-worker, prefetching loader (the JAX package's
    `DataLoader`, single process by default).

    Each process sees its `rank`-strided slice of the index space, shuffled
    per epoch from `seed + epoch` when `shuffle`; `num_workers` threads run
    the dataset's `__getitem__` and up to `prefetch` batches are built ahead
    of the consumer. `bucket_widths` groups instances by their minimal text
    width (`dataset.instance_widths()`) into batches of a few static widths
    (lossless length bucketing; needs `drop_last`). `set_epoch(epoch,
    start_batch)` reshuffles and, for a mid-epoch resume, skips the first
    `start_batch` batches of the next pass.

    Yields (batch_dict, meta_list) where batch_dict maps field → stacked
    numpy array and meta_list carries per-example non-tensor info (ids).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 999,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        rank: int = 0,
        world_size: int = 1,
        epoch: int = 0,
        bucket_widths=None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.rank = rank
        self.world_size = world_size
        self.epoch = epoch
        self.start_batch = 0
        self.bucket_widths = None
        if bucket_widths:
            full = int(getattr(dataset, "context", 0))
            caps = sorted({int(w) for w in bucket_widths})
            if not full:
                raise ValueError("bucket_widths needs dataset.context")
            if caps and caps[-1] < full:
                caps.append(full)
            if not drop_last:
                raise ValueError("bucket_widths requires drop_last=True")
            self.bucket_widths = caps

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Reshuffle per epoch (reference `train_sampler.set_epoch`)."""
        self.epoch = epoch
        self.start_batch = start_batch

    def _global_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return order

    def _indices(self) -> np.ndarray:
        order = self._global_order()
        # pad so every rank gets the same number of samples, then stride
        per_rank = -(-len(order) // self.world_size)
        padded = np.resize(order, per_rank * self.world_size)
        return padded[self.rank :: self.world_size]

    def _plan(self):
        """This rank's batch plan: a list of (index_chunk, width_or_None),
        deterministic in (seed, epoch) and length-identical on every rank."""
        if self.bucket_widths is None:
            indices = self._indices()
            if self.drop_last:
                nb = len(indices) // self.batch_size
            else:
                nb = -(-len(indices) // self.batch_size)
            return [
                (indices[b * self.batch_size : (b + 1) * self.batch_size], None)
                for b in range(nb)
            ]
        order = self._global_order()
        widths = np.asarray(self.dataset.instance_widths(num_workers=self.num_workers))
        caps = self.bucket_widths
        G = self.batch_size * self.world_size
        # each instance goes to the narrowest cap that fits it; per cap
        # (ascending) emit full global batches in epoch order and cascade the
        # remainder into the next (wider) cap, so exactly n mod G instances
        # are left unbatched at the end (== plain drop_last)
        assign = np.searchsorted(caps, widths[order])
        plan = []
        carry = order[:0]
        for bi, cap in enumerate(caps):
            members = np.concatenate([carry, order[assign == bi]])
            nb = len(members) // G
            for b in range(nb):
                plan.append((members[b * G : (b + 1) * G], cap))
            carry = members[nb * G :]
        # interleave widths across the epoch (no short-texts-first curriculum)
        rng = np.random.default_rng(self.seed + self.epoch + 1)
        rng.shuffle(plan)
        return [(chunk[self.rank :: self.world_size], cap) for chunk, cap in plan]

    def __len__(self) -> int:
        if self.bucket_widths is not None:
            return len(self._plan())
        per_rank = len(self._indices())
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)

    def _collate(self, examples, width):
        tensors = {k: np.stack([ex[0][k] for ex in examples]) for k in examples[0][0]}
        tensors.update(self.dataset.batch_extras(len(examples)))
        tensors = self.dataset.finalize_batch(tensors)
        if width is not None and width < getattr(self.dataset, "context", width):
            tensors = self.dataset.apply_bucket(tensors, width)
        return tensors, [ex[1] for ex in examples]

    def __iter__(self) -> Iterator:
        plan = self._plan()
        plan = plan[min(self.start_batch, len(plan)) :]
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending: collections.deque = collections.deque()
            for chunk, width in plan:
                futures = [pool.submit(self.dataset.__getitem__, int(i)) for i in chunk]
                pending.append((futures, width))
                if len(pending) > self.prefetch:
                    futures, w = pending.popleft()
                    yield self._collate([f.result() for f in futures], w)
            while pending:
                futures, w = pending.popleft()
                yield self._collate([f.result() for f in futures], w)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
