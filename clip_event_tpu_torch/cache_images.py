"""Build the offline preprocessed-image cache of a corpus (counterpart of
the repo's `cache_images.py`, the same flags and stats line).

Preprocesses every image under --image-dir (JPEG decode + bit-exact CLIP
resize/crop, native C++ path where it builds) once into a memory-mapped
uint8 cache that the train and eval loaders read directly. Activate it with
the `image_cache` config key or `CLIP_EVENT_IMAGE_CACHE=<out dir>`.

    python -m clip_event_tpu_torch.cache_images --image-dir data/voa/jpg --out cache/voa224
    python -m clip_event_tpu_torch.cache_images --list files.txt --out cache/voa224 --size 224

Prints one JSON stats line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--image-dir", help="directory scanned recursively for images")
    parser.add_argument("--list", dest="list_file", help="file with one image path per line")
    parser.add_argument("--out", required=True, help="cache output directory")
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--workers", type=int, default=os.cpu_count() or 8)
    parser.add_argument("--relative-to", help="key images by path relative to this dir (default: basename)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from clip_event_tpu_torch.data.cache import build_image_cache, scan_image_files

    if bool(args.image_dir) == bool(args.list_file):
        parser.error("exactly one of --image-dir / --list is required")
    if args.image_dir:
        paths = scan_image_files(args.image_dir)
    else:
        with open(args.list_file) as fh:
            paths = [line.strip() for line in fh if line.strip()]

    t0 = time.perf_counter()
    stats = build_image_cache(paths, args.out, size=args.size, num_workers=args.workers,
                              relative_to=args.relative_to)
    dt = time.perf_counter() - t0
    stats.update({
        "seconds": round(dt, 2),
        "images_per_sec": round(stats["images"] / dt, 1) if dt > 0 else 0.0,
        "out": os.path.abspath(args.out),
    })
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
