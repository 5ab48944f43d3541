"""MEED movie-event eval dataset (reference `dataset_meed.py`); own copy of
`clip_event_tpu/data/meed.py`.

Prompt modes (dataset_meed.py:160-182): verbprefix / eventprefix / verb /
event / text. In `text` mode each annotation's texts become separate
instances; the reference duplicates `text[1]` and drops `text[2]`
(`dataset_meed.py:173-182`, a latent bug) — here all texts are used.
"""

from __future__ import annotations

import json
import logging
import os

from clip_event_tpu_torch.data.common import ExampleDataset, load_image_file
from clip_event_tpu_torch.tokenizer import tokenize

log = logging.getLogger(__name__)

PROMPTS = ("verbprefix", "eventprefix", "verb", "event", "text")


class MEEDDataset(ExampleDataset):
    def __init__(
        self,
        anno_json: str,
        image_dir: str,
        ontology_json: str = None,  # kept for interface parity; unused
        prompt: str = "verbprefix",
        image_size: int = 224,
    ):
        if prompt not in PROMPTS:
            raise ValueError(f"prompt must be one of {PROMPTS}")
        self.image_dir = image_dir
        self.image_size = image_size
        self.data = []
        with open(anno_json) as fh:
            records = json.load(fh)
        for rec in records:
            image_id = rec["image_name"]
            verb = rec["trigger"]["word"]
            event = rec["event"]
            if prompt == "verbprefix":
                descs = [f"An image of {verb}"]
            elif prompt == "eventprefix":
                descs = ["An image of %s" % event.split(".")[-1].lower()]
            elif prompt == "verb":
                descs = [verb]
            elif prompt == "event":
                descs = [event.split(".")[-1].lower()]
            else:  # text
                descs = list(rec["text"])
            for d in descs:
                self.data.append({"image_id": image_id, "desc": d})
        log.info("Loaded %d instances from %s", len(self.data), anno_json)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        tensors = {
            "image": load_image_file(
                os.path.join(self.image_dir, inst["image_id"]), self.image_size
            ),
            "text": tokenize(inst["desc"])[0],
        }
        return tensors, {"image_id": inst["image_id"], "desc": inst["desc"]}
