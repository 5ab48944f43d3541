"""VOA news image–caption pairs for zero-shot matching (the caption half of
`clip_event_tpu/data/voa.py`; reference `dataset_voa.py:61-159`).

Consumes `image_caption_mapping.json`: {doc_id: {idx: {url, cap}}}. The
contrastive fine-tuning dataset (`VOADescriptionDataset`) belongs to the
training slice and is not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Sequence

import numpy as np

from clip_event_tpu_torch.data.common import ExampleDataset, load_image_file, shorten_context
from clip_event_tpu_torch.tokenizer import tokenize

log = logging.getLogger(__name__)


def clean_image_id(image_id: str) -> str:
    return image_id.replace(".", "_")


def load_image_caption_pairs(
    image_caption_jsons: Sequence[str], image_dirs: Sequence[str]
) -> List[dict]:
    """Flatten {doc: {idx: {url, cap}}} files into per-image records."""
    records = []
    for mapping_json, image_dir in zip(image_caption_jsons, image_dirs):
        with open(mapping_json) as fh:
            data = json.load(fh)
        for doc_id in data:
            for image_idx in data[doc_id]:
                records.append(
                    {
                        "image_id": clean_image_id(f"{doc_id}_{image_idx}"),
                        "image_dir": image_dir,
                        "url": data[doc_id][image_idx].get("url", ""),
                        "caption": shorten_context(
                            data[doc_id][image_idx]["cap"], limit=10**9
                        ),
                    }
                )
    return records


class VOACaptionDataset(ExampleDataset):
    """Image–caption pairs; identity contrastive labels."""

    def __init__(
        self,
        image_caption_jsons: Sequence[str],
        image_dirs: Sequence[str],
        image_size: int = 224,
    ):
        self.image_size = image_size
        self.data = load_image_caption_pairs(image_caption_jsons, image_dirs)
        log.info("Loaded %d instances from %s", len(self.data), image_caption_jsons)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        path = os.path.join(inst["image_dir"], inst["image_id"] + ".jpg")
        tensors = {
            "image": load_image_file(path, self.image_size),
            "text": tokenize(inst["caption"])[0],
        }
        return tensors, {"image_id": inst["image_id"], "caption": inst["caption"]}

    def batch_extras(self, batch_size: int):
        eye = np.arange(batch_size, dtype=np.int32)
        return {
            "labels_per_image": eye,
            "labels_per_text": eye,
            "index_pos": eye,
        }
