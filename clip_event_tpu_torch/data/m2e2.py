"""M2E2 multimedia event extraction — zero-shot eval dataset.

The reference's `dataset_m2e2.py` is incomplete/broken in the snapshot
(undefined `template_choice`/`candidates_vec`, `dataset_m2e2.py:109,149`);
this implements the documented capability (README.md:212-215) under the
M2E2 benchmark's evaluation protocol (Li et al., ACL 2020, "Cross-media
Structured Common Space for Multimedia Event Extraction"): the image set
contains both event-bearing and event-free images, an image may carry
multiple gold event mentions, and arguments are role-typed bounding boxes.
Candidates are one template description per ontology event type, tokenized
once as a fixed [T, 77] matrix; zero-shot prediction is the argmax over
image–candidate similarities (optionally thresholded to predict "no event").

Artifact contracts:
  * image_anno json — per image either the legacy single-mention form
      {image_id: {"event_type": str, "role": {role: [xyxy, ...]}}}
    or the multi-mention form
      {image_id: {"events": [{"event_type": str, "role": {...}}, ...]}}
    An entry with "event_type": null or "events": [] marks an annotated
    NEGATIVE image (no gold mention). Gold boxes are normalized xyxy.
  * image_list json (optional) — a list of image ids defining the full
    evaluation set; ids absent from image_anno are negative images (the
    M2E2 protocol evaluates over all images, most of which carry no event).
  * ie_ontology json — {event_type: template_str} or
    {event_type: {"template": str, "roles": {role: description_str}}}
    (the roles enable zero-shot argument grounding in evals/m2e2.py).

Own copy of `clip_event_tpu/data/m2e2.py` for the port.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from clip_event_tpu_torch.data.common import ExampleDataset, load_image_file
from clip_event_tpu_torch.tokenizer import tokenize

log = logging.getLogger(__name__)


class M2E2Dataset(ExampleDataset):
    def __init__(
        self,
        image_anno: str,
        image_dir: str,
        ie_ontology_json: str,
        image_list: str | None = None,
        image_suffix: str = ".jpg",
        image_size: int = 224,
    ):
        self.image_dir = image_dir
        self.image_suffix = image_suffix
        self.image_size = image_size

        with open(ie_ontology_json) as fh:
            ontology = json.load(fh)
        self.event_types = list(ontology.keys())
        self.event_type_to_idx = {t: i for i, t in enumerate(self.event_types)}
        self.templates = []
        self.role_descriptions = {}  # {event_type: {role: description}}
        for t in self.event_types:
            spec = ontology[t]
            if isinstance(spec, dict):
                self.templates.append(spec["template"])
                self.role_descriptions[t] = dict(spec.get("roles", {}))
            else:
                self.templates.append(spec)
                self.role_descriptions[t] = {}
        self.candidate_tokens = tokenize(self.templates)  # [T, 77]

        with open(image_anno) as fh:
            anno = json.load(fh)
        ids = list(anno.keys())
        if image_list:
            with open(image_list) as fh:
                listed = json.load(fh)
            ids += [i for i in listed if i not in anno]

        self.data = []
        n_mentions = n_negative = 0
        for image_id in ids:
            inst = anno.get(image_id) or {}
            raw = inst.get("events")
            if raw is None:
                raw = [inst] if inst.get("event_type") else []
            mentions = []
            for m in raw:
                etype = m.get("event_type")
                if etype not in self.event_type_to_idx:
                    log.warning("unknown event type %s for %s", etype, image_id)
                    continue
                mentions.append(
                    {"event_type": etype, "arguments": m.get("role", {})}
                )
            n_mentions += len(mentions)
            n_negative += not mentions
            self.data.append(
                {
                    "image_id": image_id,
                    "mentions": mentions,
                    # first gold type, -1 on negatives (secondary
                    # accuracy/macro metrics; the primary P/R/F1 uses the
                    # full mention list from the metas)
                    "event_type_idx": (
                        self.event_type_to_idx[mentions[0]["event_type"]]
                        if mentions else -1
                    ),
                }
            )
        log.info(
            "Loaded %d images (%d event mentions, %d negative images), "
            "%d event types",
            len(self.data), n_mentions, n_negative, len(self.event_types),
        )

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        path = os.path.join(self.image_dir, inst["image_id"] + self.image_suffix)
        tensors = {
            "image": load_image_file(path, self.image_size),
            "event_type_idx": np.int32(inst["event_type_idx"]),
        }
        return tensors, {
            "image_id": inst["image_id"],
            "mentions": inst["mentions"],
            # legacy field: first mention's arguments
            "arguments": (
                inst["mentions"][0]["arguments"] if inst["mentions"] else {}
            ),
        }
