"""GSR / SWiG grounded situation recognition (counterpart of
`clip_event_tpu/data/sr.py`; reference `dataset_sr.py`).

Per image: a gold verb + per-role gold bounding boxes and noun types; the
eval scores verb classification against a fixed candidate-verb text matrix
and argument grounding against IoU≥0.5. Four prompt styles for the verb and
role descriptions (def / abstract / name / short, `dataset_sr.py:225-252`).

Static-shape contract: roles are padded to `max_roles` with a mask; bboxes
are normalized xyxy (degenerate boxes fixed as in `dataset_sr.py:159-170`);
missing boxes carry -1s.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from collections import Counter, defaultdict
from operator import itemgetter
from typing import Optional

import numpy as np

from clip_event_tpu_torch.data.common import ExampleDataset, load_image_file, load_object_label_map
from clip_event_tpu_torch.ops.bbox import normalize_bbox
from clip_event_tpu_torch.tokenizer import CONTEXT_LENGTH, tokenize

log = logging.getLogger(__name__)

PROMPTS = ("def", "abstract", "name", "short")


class GSRDataset(ExampleDataset):
    def __init__(
        self,
        anno_json: str,
        image_dir: str,
        ontology_json: str,
        prompt: str = "name",
        max_roles: int = 6,
        # optional detected-object channel (bboxes + labels only)
        load_object: bool = False,
        object_detection: Optional[str] = None,
        object_class_map: Optional[str] = None,
        object_threshold: float = 0.2,
        object_topk: int = 40,
        image_size: int = 224,
    ):
        if prompt not in PROMPTS:
            raise ValueError(f"prompt must be one of {PROMPTS}")
        self.prompt = prompt
        self.image_dir = image_dir
        self.image_size = image_size
        self.max_roles = max_roles

        with open(ontology_json) as fh:
            space = json.load(fh)
        self.ontology_verbs = space["verbs"]
        self.ontology_nouns = space["nouns"]

        self.candidate_verbs = list(self.ontology_verbs.keys())
        self.verb_to_idx = {v: i for i, v in enumerate(self.candidate_verbs)}
        self.candidate_tokens = tokenize(self.candidate_verbs)  # [V, 77]

        self.load_object = load_object
        if load_object:
            self.object_threshold = object_threshold
            self.object_topk = object_topk
            self.object_label_map = load_object_label_map(object_class_map)
            with open(object_detection, "rb") as fh:
                self.object_results = pickle.load(fh)

        self.data = []
        with open(anno_json) as fh:
            anno = json.load(fh)
        for image_id, inst in anno.items():
            self.data.append(self._parse_instance(image_id, inst))
        log.info("Loaded %d instances, %d candidate verbs", len(self.data), len(self.candidate_verbs))

    # ----------------------------------------------------------- prompts

    def verb_description(self, verb: str) -> str:
        if self.prompt == "def":
            return self.ontology_verbs[verb]["def"]
        if self.prompt == "abstract":
            return self.ontology_verbs[verb]["abstract"]
        if self.prompt == "name":
            return verb
        return f"An image of {verb} event."  # short

    def role_description(self, verb: str, role: str, noun_type) -> str:
        if self.prompt == "def":
            return self.ontology_verbs[verb]["roles"][role]["def"]
        if self.prompt == "abstract":
            return self.ontology_verbs[verb]["roles"][role]["framenet"]
        if self.prompt == "name":
            return f"The {role} of {verb}."
        if noun_type is None:
            return f"The object is {verb} {role}."
        return f"The {noun_type} is {verb} {role}."

    # -------------------------------------------------------------- load

    def _parse_instance(self, image_id: str, inst: dict) -> dict:
        verb = inst["verb"]
        height, width = inst["height"], inst["width"]

        # most-common noun gloss per role across annotator frames
        noun_votes = defaultdict(Counter)
        for frame in inst.get("frames", []):
            for role, noun_id in frame.items():
                if noun_id:
                    noun_votes[role].update(self.ontology_nouns[noun_id]["gloss"])

        roles, role_descs, noun_types, bboxes = [], [], [], []
        for role, bbox in inst.get("bb", {}).items():
            role = role.replace("sources", "source")
            noun = noun_votes[role].most_common(1)[0][0] if noun_votes[role] else None
            noun_types.append(noun)
            role_descs.append(self.role_description(verb, role, noun))
            roles.append(role)
            if bbox[0] != -1:
                bbox = list(bbox)
                if bbox[3] == bbox[1]:
                    bbox[3] += 2
                if bbox[2] == bbox[0]:
                    bbox[2] += 2
                bboxes.append(list(normalize_bbox(bbox, width=width, height=height)))
            else:
                bboxes.append([-1.0, -1.0, -1.0, -1.0])

        rec = {
            "image_id": image_id,
            "verb": verb,
            "verb_idx": self.verb_to_idx[verb],
            "verb_desc": self.verb_description(verb),
            "roles": roles,
            "role_descs": role_descs,
            "noun_types": noun_types,
            "bboxes": bboxes,
        }

        if self.load_object:
            obj_bboxes, obj_labels = [], []
            for det in sorted(self.object_results.get(image_id, []), key=itemgetter("score")):
                if len(obj_bboxes) >= self.object_topk:
                    break
                if det["label"] not in self.object_label_map or det["score"] < self.object_threshold:
                    continue
                obj_bboxes.append(list(det.get("bbox_normalized", det["bbox"])))
                obj_labels.append(self.object_label_map[det["label"]])
            rec["object_bboxes"] = obj_bboxes
            rec["object_labels"] = obj_labels
        return rec

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        path = os.path.join(self.image_dir, inst["image_id"])
        R = self.max_roles
        n = min(len(inst["roles"]), R)

        role_tokens = np.zeros((R, CONTEXT_LENGTH), np.int32)
        if n:
            role_tokens[:n] = tokenize(inst["role_descs"][:n])
        role_mask = np.zeros(R, np.int32)
        role_mask[:n] = 1
        bboxes = np.full((R, 4), -1.0, np.float32)
        if n:
            bboxes[:n] = np.asarray(inst["bboxes"][:n], np.float32)

        tensors = {
            "image": load_image_file(path, self.image_size),
            "verb_text": tokenize(inst["verb_desc"])[0],
            "verb_idx": np.int32(inst["verb_idx"]),
            "role_text": role_tokens,
            "role_mask": role_mask,
            "role_bbox": bboxes,
        }
        meta = {k: inst[k] for k in ("image_id", "verb", "roles", "noun_types")}
        if self.load_object:
            meta["object_bboxes"] = inst["object_bboxes"]
            meta["object_labels"] = inst["object_labels"]
        return tensors, meta
