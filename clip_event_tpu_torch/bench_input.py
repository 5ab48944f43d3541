"""Host input-pipeline benchmark (counterpart of the repo's
`bench_input.py`, the same output keys).

Measures loader throughput (JPEG decode + bit-exact CLIP preprocessing +
batch assembly) on a synthetic 480×640 JPEG corpus: the native C++ path
against PIL, a thread sweep, the offline cache's build rate and its cached
read rate. Host only: no card is involved.

    python -m clip_event_tpu_torch.bench_input [--images N]

Prints one JSON line of images/s.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", type=int, default=256, help="synthetic JPEGs in the corpus")
    args = parser.parse_args(argv)
    workers = os.cpu_count() or 8
    from PIL import Image

    from clip_event_tpu_torch.data import cache as image_cache
    from clip_event_tpu_torch.data.common import DataLoader, ExampleDataset, load_image_file

    results = {}
    old_native = os.environ.get("CLIP_EVENT_NATIVE")
    with tempfile.TemporaryDirectory(prefix="bench_input_") as tmp:
        rng = np.random.default_rng(0)
        paths = []
        for i in range(args.images):
            arr = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
            p = os.path.join(tmp, f"{i}.jpg")
            Image.fromarray(arr).save(p, quality=90)
            paths.append(p)

        class JpegDataset(ExampleDataset):
            def __len__(self):
                return len(paths)

            def __getitem__(self, idx):
                return {"image": load_image_file(paths[idx], 224)}, {}

        def throughput(num_workers: int) -> float:
            loader = DataLoader(JpegDataset(), batch_size=32, shuffle=False,
                                num_workers=num_workers, drop_last=False)
            # one warm batch (builds the native library, fills the taps' caches)
            next(iter(loader))
            t0 = time.perf_counter()
            seen = 0
            for tensors, _ in loader:
                seen += tensors["image"].shape[0]
            return seen / (time.perf_counter() - t0)

        try:
            for native_flag, tag in (("1", "native"), ("0", "python_pil")):
                os.environ["CLIP_EVENT_NATIVE"] = native_flag
                results[f"{tag}_images_per_sec"] = round(throughput(workers), 1)
            # thread scaling of the native path: its ctypes calls release
            # the GIL, so the rate should follow threads up to the cores
            os.environ["CLIP_EVENT_NATIVE"] = "1"
            for w in (1, 2, 4):
                results[f"native_{w}w_images_per_sec"] = round(throughput(w), 1)
            results["thread_scaling_4w_over_1w"] = round(
                results["native_4w_images_per_sec"] / max(results["native_1w_images_per_sec"], 1e-9), 2)
            results["speedup"] = round(
                results["native_images_per_sec"] / results["python_pil_images_per_sec"], 2)

            # the offline cache: decode + resample once up front, then the
            # loader reads bit-exact uint8 memmap rows
            cache_dir = os.path.join(tmp, "cache")
            t0 = time.perf_counter()
            image_cache.build_image_cache(paths, cache_dir, size=224, num_workers=workers)
            results["cache_build_images_per_sec"] = round(args.images / (time.perf_counter() - t0), 1)
            image_cache.activate(cache_dir)
            try:
                results["cached_images_per_sec"] = round(throughput(workers), 1)
                for w in (1, 2, 4):
                    results[f"cached_{w}w_images_per_sec"] = round(throughput(w), 1)
            finally:
                image_cache.activate(None)
        finally:
            if old_native is None:
                os.environ.pop("CLIP_EVENT_NATIVE", None)
            else:
                os.environ["CLIP_EVENT_NATIVE"] = old_native
    results["cache_speedup"] = round(results["cached_images_per_sec"] / results["native_images_per_sec"], 2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
