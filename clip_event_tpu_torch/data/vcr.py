"""VCR visual commonsense reasoning — 4-choice eval (reference `dataset_vcr.py`).

Each record: image + question + 4 answer (or rationale) choices, with
detected-object names substituted into the token lists (`fill_name`,
`dataset_vcr.py:115-120`). Batch text flattens to [B·4, 77]
(`dataset_vcr.py:148-149`); the label is the correct choice index.

Own copy of `clip_event_tpu/data/vcr.py` for the port.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from clip_event_tpu_torch.data.common import ExampleDataset, load_image_file
from clip_event_tpu_torch.tokenizer import tokenize

log = logging.getLogger(__name__)

NUM_CHOICES = 4


def fill_names(word_list, object_names):
    """Substitute `[obj_idx, ...]` references with object names."""
    words = []
    for word in word_list:
        if isinstance(word, list):
            words.append(" and ".join(object_names[i] for i in word))
        else:
            words.append(word)
    return " ".join(words)


class VCRDataset(ExampleDataset):
    def __init__(
        self,
        qa_jsonl: str,
        image_dir: str,
        rationale: bool = False,
        image_size: int = 224,
    ):
        self.image_dir = image_dir
        self.image_size = image_size
        self.data = []
        with open(qa_jsonl) as fh:
            for line in fh:
                rec = json.loads(line)
                objects = rec["objects"]
                choices_key = "rationale_choices" if rationale else "answer_choices"
                label_key = "rationale_label" if rationale else "answer_label"
                self.data.append(
                    {
                        "anno_id": rec["annot_id"],
                        "image": rec["img_fn"],
                        "question": fill_names(rec["question"], objects),
                        "descriptions": [
                            fill_names(c, objects) for c in rec[choices_key]
                        ],
                        "label": rec[label_key],
                    }
                )
        log.info("Loaded %d instances from %s", len(self.data), qa_jsonl)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        tensors = {
            "image": load_image_file(
                os.path.join(self.image_dir, inst["image"]), self.image_size
            ),
            "text": tokenize(inst["descriptions"]),  # [4, 77]
            "label": np.int32(inst["label"]),
        }
        meta = {"anno_id": inst["anno_id"], "question": inst["question"]}
        return tensors, meta

    def finalize_batch(self, tensors):
        tensors["text"] = tensors["text"].reshape(-1, tensors["text"].shape[-1])
        return tensors
