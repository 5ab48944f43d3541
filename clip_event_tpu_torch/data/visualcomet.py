"""VisualCOMET dataset — written fresh (the reference documents the eval,
README.md:225-229, but ships neither loader nor script).

Public VisualCOMET annotation format: a json list of
{img_fn, movie, place, event, intent: [...], before: [...], after: [...]}.
Zero-shot task realized here: rank each image's gold inference texts
(field selectable: event / intent / before / after) against the pool of all
inference texts in the split — image→text retrieval over commonsense
inferences.

Own copy of `clip_event_tpu/data/visualcomet.py` for the port.
"""

from __future__ import annotations

import json
import logging
import os


from clip_event_tpu_torch.data.common import ExampleDataset, load_image_file
from clip_event_tpu_torch.tokenizer import tokenize

log = logging.getLogger(__name__)

FIELDS = ("event", "intent", "before", "after")


class VisualCOMETDataset(ExampleDataset):
    def __init__(
        self,
        anno_json: str,
        image_dir: str,
        field: str = "event",
        prompt: str = "",
        image_size: int = 224,
    ):
        if field not in FIELDS:
            raise ValueError(f"field must be one of {FIELDS}")
        self.image_dir = image_dir
        self.image_size = image_size
        self.field = field

        self.data = []
        self.candidates = []  # pool of inference texts
        seen = {}
        for rec in json.load(open(anno_json)):
            values = rec.get(field)
            if values is None:
                continue
            if isinstance(values, str):
                values = [values]
            gold_ids = []
            for v in values:
                text = (prompt + v).strip()
                if text not in seen:
                    seen[text] = len(self.candidates)
                    self.candidates.append(text)
                gold_ids.append(seen[text])
            self.data.append({"image": rec["img_fn"], "gold_ids": gold_ids})
        self.candidate_tokens = tokenize(self.candidates)
        log.info(
            "Loaded %d images, %d candidate %s texts",
            len(self.data), len(self.candidates), field,
        )

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        tensors = {
            "image": load_image_file(
                os.path.join(self.image_dir, inst["image"]), self.image_size
            ),
        }
        return tensors, {"image": inst["image"], "gold_ids": inst["gold_ids"]}
