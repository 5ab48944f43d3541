"""Image–text retrieval datasets: COCO (Karpathy json) and Flickr30k
(reference `dataset_coco.py`, `dataset_flicker.py`).

Each image carries exactly `captions_per_image` prompted captions; batches
are [B, H, W, 3] images + [B·C, 77] caption tokens.

Own copy of `clip_event_tpu/data/retrieval.py` for the port.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict

from clip_event_tpu_torch.data.common import ExampleDataset, load_image_file
from clip_event_tpu_torch.tokenizer import tokenize

log = logging.getLogger(__name__)


class _RetrievalDataset(ExampleDataset):
    captions_per_image = 5

    def __init__(self, image_dir, image_size=224):
        self.image_dir = image_dir
        self.image_size = image_size
        self.data = []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        tensors = {
            "image": load_image_file(
                os.path.join(self.image_dir, inst["image_id"]), self.image_size
            ),
            "text": tokenize(inst["captions"][: self.captions_per_image]),
        }
        return tensors, {"image_id": inst["image_id"], "captions": inst["captions"]}

    def finalize_batch(self, tensors):
        tensors["text"] = tensors["text"].reshape(-1, tensors["text"].shape[-1])
        return tensors


class COCODataset(_RetrievalDataset):
    """Karpathy-split COCO captions; image list comes from `image_dir`
    (reference `dataset_coco.py:64-106`)."""

    def __init__(self, caption_file, image_dir, prompt="An photo of", image_size=224):
        super().__init__(image_dir, image_size)
        captions = defaultdict(list)
        for rec in json.load(open(caption_file))["images"]:
            image_id = rec["filename"].split("_")[-1]
            for sent in rec["sentences"]:
                captions[image_id].append(prompt + sent["raw"].lower())
        for image_id in sorted(os.listdir(image_dir)):
            if image_id not in captions:
                raise RuntimeError(f"No captions '{image_id}'.")
            self.data.append({"image_id": image_id, "captions": captions[image_id]})
        log.info("Loaded %d instances from %s", len(self.data), image_dir)


class FlickrDataset(_RetrievalDataset):
    """Flickr30k: split list + '|'-separated caption csv with the
    'An photo of ' prompt (reference `dataset_flicker.py:63-96`)."""

    def __init__(self, split_list, caption_file, image_dir, image_size=224):
        super().__init__(image_dir, image_size)
        captions = defaultdict(list)
        with open(caption_file) as fh:
            for line in fh:
                tabs = line.rstrip("\n").split("|")
                if len(tabs) < 3:
                    continue
                captions[tabs[0].strip()].append("An photo of " + tabs[2].strip())
        with open(split_list) as fh:
            for line in fh:
                image_id = line.strip()
                if not image_id:
                    continue
                image_id += ".jpg"
                if image_id not in captions:
                    log.warning("no captions %s", image_id)
                    continue
                self.data.append({"image_id": image_id, "captions": captions[image_id]})
        log.info("Loaded %d instances from %s", len(self.data), split_list)
