"""imSitu training-style situation recognition (reference
`dataset_situation.py`; counterpart of `clip_event_tpu/data/situation.py`).

Vocab-id based SR: per image a verb id, an ACE event id via the SR→ACE
mapping file, and (role, ee_role, noun) triples for every annotated role
value, padded to `max_args`. Optional object-crop channel identical to the
VOA one. The dense verb×role mask marks which roles each verb licenses
(`_verb_role_mask`, `dataset_situation.py:198-217` — sparse torch there,
dense numpy here; at 504×191 it is trivially small).

The reference imports vocab/norm helpers from the external m2e2 codebase
(`dataset_situation.py:15-16`, absent from the snapshot); `Vocab` and the
label normalizers are provided here with the conventional m2e2 behaviour
(UNK id 0; event labels 'B-<Type>' with 'O' for unmapped).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from clip_event_tpu_torch.data.common import (
    ExampleDataset,
    load_image_file,
    load_object_crops,
    load_object_label_map,
    pad_stack,
)

log = logging.getLogger(__name__)

UNK_IDX = 0
O_LABEL = "O"
ROLE_O_LABEL = "OTHER"


class Vocab:
    """Minimal word↔id vocab with UNK at id 0."""

    def __init__(self, words: Sequence[str], unk: str = "<UNK>"):
        self.id2word = [unk] + [w for w in words if w != unk]
        self.word2id = {w: i for i, w in enumerate(self.id2word)}

    @property
    def size(self) -> int:
        return len(self.id2word)

    def get(self, word: str) -> int:
        return self.word2id.get(word, UNK_IDX)


def event_type_norm(name: str) -> str:
    """ACE event type normalization: 'Conflict.Attack' style, '||' variants
    collapsed."""
    return name.replace("||", ".").strip()


def role_name_norm(name: str) -> str:
    return name.strip().capitalize()


def load_sr_mapping(verb_mapping_file: str):
    """TSV rows: sr_verb, sr_role, ee_event, ee_role
    (reference `load_mapping_all`, `dataset_situation.py:171-184`)."""
    verb_map: Dict[str, str] = {}
    role_map: Dict[str, Dict[str, str]] = defaultdict(dict)
    with open(verb_mapping_file, encoding="utf-8") as fh:
        for line in fh:
            tabs = line.rstrip("\n").split("\t")
            if len(tabs) < 4:
                continue
            role_map[tabs[0]][tabs[1]] = tabs[3]
            verb_map[tabs[0]] = tabs[2]
    return verb_map, role_map


class ImSituDataset(ExampleDataset):
    def __init__(
        self,
        image_dir: str,
        imsitu_ontology_file: str,
        imsitu_annotation_file: str,
        verb_mapping_file: str,
        max_args: int = 12,
        filter_irrelevant_verbs: bool = False,
        filter_place: bool = False,
        # object channel
        load_object: bool = False,
        object_ontology_file: Optional[str] = None,
        object_detection_pkl_file: Optional[str] = None,
        object_detection_threshold: float = 0.2,
        object_topk: int = 50,
        max_objects: Optional[int] = None,
        image_size: int = 224,
    ):
        self.image_dir = image_dir
        self.image_size = image_size
        self.max_args = max_args
        self.filter_place = filter_place

        with open(imsitu_ontology_file) as fh:
            space = json.load(fh)
        self.nouns = space["nouns"]
        self.verbs_info = space["verbs"]
        with open(imsitu_annotation_file) as fh:
            self.annotation = json.load(fh)
        self.sr_verb_map, self.sr_role_map = load_sr_mapping(verb_mapping_file)

        # vocabs
        all_roles = sorted(
            {r for v in self.verbs_info.values() for r in v["roles"]
             if not (filter_place and r.lower() == "place")}
        )
        all_nouns = sorted(
            {g for n in self.nouns.values() for g in n["gloss"]}
        )
        self.vocab_verb = Vocab(sorted(self.verbs_info.keys()))
        self.vocab_role = Vocab(all_roles)
        self.vocab_noun = Vocab(all_nouns)

        events = sorted({("B-" + event_type_norm(e)) for e in self.sr_verb_map.values()})
        self.event2id = {O_LABEL: 0}
        for e in events:
            self.event2id[e] = len(self.event2id)
        ee_roles = sorted({role_name_norm(r) for m in self.sr_role_map.values() for r in m.values()})
        self.eerole2id = {ROLE_O_LABEL: 0}
        for r in ee_roles:
            self.eerole2id[r] = len(self.eerole2id)

        # dense verb×role license mask
        self.role_mask = np.zeros((self.vocab_verb.size, self.vocab_role.size), np.float32)
        for verb, info in self.verbs_info.items():
            for role in info["roles"]:
                if filter_place and role.lower() == "place":
                    continue
                self.role_mask[self.vocab_verb.get(verb), self.vocab_role.get(role)] = 1.0

        self.load_object = load_object
        if load_object:
            self.object_threshold = object_detection_threshold
            self.object_topk = object_topk
            self.max_objects = max_objects or (object_topk + 1)
            self.object_labels = load_object_label_map(object_ontology_file)
            with open(object_detection_pkl_file, "rb") as fh:
                self.object_results = pickle.load(fh)

        self.ids = []
        for image_id in sorted(os.listdir(image_dir)):
            if image_id not in self.annotation:
                continue
            verb = self.annotation[image_id]["verb"]
            if filter_irrelevant_verbs and verb not in self.sr_verb_map:
                continue
            self.ids.append(image_id)
        log.info("number of images: %d", len(self.ids))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int):
        image_id = self.ids[idx]
        anno = self.annotation[image_id]
        verb = anno["verb"].lower()

        if verb in self.sr_verb_map:
            event_id = self.event2id["B-" + event_type_norm(self.sr_verb_map[verb])]
        else:
            event_id = self.event2id[O_LABEL]

        # aggregate role values across frames
        role_values = defaultdict(set)
        for frame in anno.get("frames", []):
            for role, noun_id in frame.items():
                role = role.lower()
                if self.filter_place and role == "place":
                    continue
                if noun_id:
                    role_values[role].update(self.nouns[noun_id]["gloss"])

        roles, roles_ee, args = [], [], []
        for role, values in role_values.items():
            ee = (
                role_name_norm(self.sr_role_map[verb][role])
                if verb in self.sr_role_map and role in self.sr_role_map[verb]
                else ROLE_O_LABEL
            )
            for value in sorted(values):
                roles.append(self.vocab_role.get(role))
                roles_ee.append(self.eerole2id[ee])
                args.append(self.vocab_noun.get(value))

        A = self.max_args
        n = min(len(args), A)

        def pad(xs):
            out = np.zeros(A, np.int32)
            out[:n] = np.asarray(xs[:n], np.int32)
            return out

        path = os.path.join(self.image_dir, image_id)
        tensors = {
            "verb": np.int32(self.vocab_verb.get(verb)),
            "event": np.int32(event_id),
            "roles": pad(roles),
            "roles_ee": pad(roles_ee),
            "args": pad(args),
            "arg_num": np.int32(n),
        }
        meta = {"image_id": image_id, "verb": verb}

        if self.load_object:
            crops, obj_ids, obj_labels = load_object_crops(
                path,
                self.object_results.get(image_id, []),
                self.object_labels,
                threshold=self.object_threshold,
                topk=min(self.object_topk, self.max_objects - 1),
                size=self.image_size,
            )
            tensors["image"] = crops[0]
            tensors["object_image"] = pad_stack(list(crops), self.max_objects)
            mask = np.zeros(self.max_objects, np.int32)
            mask[: min(len(crops), self.max_objects)] = 1
            tensors["object_mask"] = mask
            tensors["object_label"] = pad_stack(
                [np.int32(self.vocab_noun.get(l)) for l in obj_labels],
                self.max_objects, pad_shape=(), dtype=np.int32,
            )
            meta["object_ids"] = obj_ids
        else:
            tensors["image"] = load_image_file(path, self.image_size)
        return tensors, meta
