"""Offline preprocessed-image cache, memory-mapped and bit-exact
(counterpart of `clip_event_tpu/data/cache.py`, the same files).

The reference decodes and resizes every JPEG inside the train loop on every
epoch (`dataset_voa.py:478-544`). This module preprocesses a corpus once and
memory-maps the result for every later pass.

Representation: the uint8 resize + crop stage (`preprocess_image_u8`), the
last integer stage of the reference transform and bitwise equal to
PIL/torchvision, stored as one `[N, size, size, 3]` uint8 memmap
(`images.u8`, 150 KB an image at 224²) and a JSON index of image keys to
rows. Normalization to float32 happens at read time, so a hit reproduces
`load_image_file` exactly without the JPEG decode and the bicubic resample.

Layout under the cache dir:
  images.u8    raw memmap, shape [N, size, size, 3], C order
  index.json   {"size": int, "count": int, "keys": {key: row}}

Keys default to the image basename (unique in the VOA naming scheme);
`relative_to` keys by directory-relative path where basenames may collide.
The JAX package's cache of the same files is these bytes, and each package
reads the other's.

Activation: `activate(cache_dir)` installs a process-global cache that
`data.common.load_image_file` consults first, or set
`CLIP_EVENT_IMAGE_CACHE` (read once, lazily). Misses fall through to the
live decode.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from clip_event_tpu_torch.data.transform import normalize, preprocess_image_u8

log = logging.getLogger(__name__)

_INDEX_NAME = "index.json"
_DATA_NAME = "images.u8"


def _preprocess_one_u8(path: str, size: int) -> np.ndarray:
    """Decode + resize + crop one image file to uint8 [size, size, 3]."""
    if os.environ.get("CLIP_EVENT_NATIVE", "1") != "0" and path.lower().endswith((".jpg", ".jpeg")):
        from clip_event_tpu_torch.data import native

        out = native.preprocess_jpeg_file_u8(path, size)
        if out is not None:
            return out

    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = 933120000
    with Image.open(path) as img:
        return preprocess_image_u8(img, size)


def path_key(path: str, relative_to: Optional[str] = None) -> str:
    if relative_to is not None:
        return os.path.relpath(os.path.abspath(path), os.path.abspath(relative_to))
    return os.path.basename(path)


def build_image_cache(
    paths: Sequence[str],
    cache_dir: str,
    size: int = 224,
    num_workers: int = 8,
    relative_to: Optional[str] = None,
) -> Dict[str, int]:
    """Preprocess `paths` once into `cache_dir`; returns stats.

    Workers are threads (the native decode releases the GIL). Unreadable
    images are skipped and counted, never fatal: the loader decodes them
    live. The index lists keys in row order (a later duplicate key takes
    its row), whatever order the threads finish in.
    """
    os.makedirs(cache_dir, exist_ok=True)
    paths = list(paths)
    n = len(paths)
    mm = np.memmap(
        os.path.join(cache_dir, _DATA_NAME), mode="w+", dtype=np.uint8,
        shape=(max(n, 1), size, size, 3),
    )

    def work(row: int) -> bool:
        path = paths[row]
        try:
            mm[row] = _preprocess_one_u8(path, size)
        except Exception as exc:  # any unreadable file: skipped, counted
            log.warning("cache: skipping %s (%s)", path, exc)
            return False
        return True

    ok: List[bool] = []
    chunk = 1024  # bounds the in-flight task list
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for start in range(0, n, chunk):
            ok += pool.map(work, range(start, min(start + chunk, n)))
            if len(ok) % 10240 < chunk:
                log.info("cache: %d/%d images", len(ok), n)
    mm.flush()
    del mm
    keys = {path_key(p, relative_to): row for row, p in enumerate(paths) if ok[row]}
    with open(os.path.join(cache_dir, _INDEX_NAME), "w") as fh:
        json.dump({"size": size, "count": n, "keys": keys}, fh)
    failed = n - sum(ok)
    return {"images": n - failed, "failed": failed, "size": size}


def scan_image_files(root: str, exts: Iterable[str] = (".jpg", ".jpeg", ".png")) -> List[str]:
    """Recursively list image files under `root`, sorted for determinism."""
    exts = tuple(e.lower() for e in exts)
    out: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name.lower().endswith(exts):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


class ImageCache:
    """Read side: memory-mapped uint8 rows, normalized to float32 on get."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, _INDEX_NAME)) as fh:
            index = json.load(fh)
        self.size = int(index["size"])
        self.keys: Dict[str, int] = index["keys"]
        count = max(int(index["count"]), 1)
        self._mm = np.memmap(
            os.path.join(cache_dir, _DATA_NAME), mode="r", dtype=np.uint8,
            shape=(count, self.size, self.size, 3),
        )
        self.cache_dir = cache_dir

    def _row(self, path: str, size: int) -> Optional[int]:
        if size != self.size:
            return None
        row = self.keys.get(path)
        if row is None:
            row = self.keys.get(os.path.basename(path))
        return row

    def get_u8(self, path: str, size: int = 224) -> Optional[np.ndarray]:
        """uint8 [size, size, 3], exactly `load_image_file(path, size, raw=True)`."""
        row = self._row(path, size)
        if row is None:
            return None
        return np.asarray(self._mm[row])

    def get(self, path: str, size: int = 224) -> Optional[np.ndarray]:
        """float32 [size, size, 3], exactly `load_image_file(path, size)`
        on the pure-Python path (1 ulp from the native float path)."""
        u8 = self.get_u8(path, size)
        if u8 is None:
            return None
        return normalize(u8)

    def __len__(self) -> int:
        return len(self.keys)


_active: Optional[ImageCache] = None
_env_checked = False
_activate_lock = threading.RLock()


def activate(cache_dir: Optional[str]) -> Optional[ImageCache]:
    """Install (or clear, with None) the process-global image cache."""
    global _active, _env_checked
    with _activate_lock:
        _env_checked = True
        _active = ImageCache(cache_dir) if cache_dir else None
        if _active is not None:
            log.info("image cache active: %s (%d images @ %d px)", cache_dir, len(_active), _active.size)
        return _active


def active_cache() -> Optional[ImageCache]:
    """The installed cache, lazily honoring CLIP_EVENT_IMAGE_CACHE."""
    global _env_checked
    if not _env_checked:
        with _activate_lock:
            if not _env_checked:
                env = os.environ.get("CLIP_EVENT_IMAGE_CACHE")
                if env:
                    try:
                        activate(env)
                    except (OSError, ValueError, KeyError) as exc:
                        log.warning("CLIP_EVENT_IMAGE_CACHE=%s unusable: %s", env, exc)
                        _env_checked = True
                else:
                    _env_checked = True
    return _active
