"""Corpus repair: fetch missing images before training (counterpart of
`clip_event_tpu/data/repair.py`).

The reference downloaded missing images from their source URLs inside the
training collate (`dataset_voa.py:511-523`), an HTTP round-trip in the hot
loop. Here it is an offline step: scan the corpus once, download what is
missing (where the environment has egress), and report what is still
missing so the datasets can skip it.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Sequence

from clip_event_tpu_torch.data.voa import load_image_caption_pairs

log = logging.getLogger(__name__)


def find_missing_images(image_caption_jsons: Sequence[str], image_dirs: Sequence[str]) -> List[dict]:
    """The caption records whose `<image_dir>/<image_id>.jpg` is absent,
    each with its `path`."""
    missing = []
    for rec in load_image_caption_pairs(image_caption_jsons, image_dirs):
        path = os.path.join(rec["image_dir"], rec["image_id"] + ".jpg")
        if not os.path.exists(path):
            missing.append({**rec, "path": path})
    return missing


def repair_missing_images(
    image_caption_jsons: Sequence[str],
    image_dirs: Sequence[str],
    timeout: float = 10.0,
) -> Dict[str, int]:
    """Download every missing image from its `url`. Returns counts."""
    missing = find_missing_images(image_caption_jsons, image_dirs)
    downloaded = failed = 0
    if missing:
        import urllib.request

        for rec in missing:
            if not rec["url"]:
                failed += 1
                continue
            try:
                with urllib.request.urlopen(rec["url"], timeout=timeout) as resp:
                    data = resp.read()
                with open(rec["path"], "wb") as fh:
                    fh.write(data)
                downloaded += 1
            except (OSError, ValueError) as exc:  # URLError is an OSError; a bad URL a ValueError
                log.warning("failed to fetch %s: %s", rec["url"], exc)
                failed += 1
    summary = {"missing": len(missing), "downloaded": downloaded, "failed": failed}
    log.info("repair summary: %s", summary)
    return summary
