"""VOA news image–caption datasets (counterpart of
`clip_event_tpu/data/voa.py`; reference `dataset_voa.py`).

`VOACaptionDataset` — plain image–caption pairs for zero-shot matching
(reference `VOADataset`, `dataset_voa.py:61-159`).

`VOADescriptionDataset` — the contrastive fine-tuning workload
(`dataset_voa.py:371-688`): one positive and G hard-negative event/argument
descriptions per image, static label layouts, length buckets and
dedupe-encode fields, plus the object-crop channel and the text-IE channel
of the OT alignment loss and the SR/bbox channel of the local-attention
loss, ragged axes padded to static caps with masks.

Data artifacts consumed (same contracts as the reference):
  * image_caption_mapping.json: {doc_id: {idx: {url, cap}}}
  * descriptions_<pos>_<neg>.json: {image_id: {pos, neg_event, neg_argument}}
  * object detection .pkl: {image_id: [{label, bbox, score}, ...]}
  * class-descriptions-boxable.csv ontology, merged.cs / event_rewrite.cs
"""

from __future__ import annotations

import json
import logging
import os
from operator import itemgetter
from typing import List, Optional, Sequence

import numpy as np

from clip_event_tpu_torch.data.coldstart import (
    IEIndex,
    doc_entity_names,
    doc_event_names,
    load_ie_index,
)
from clip_event_tpu_torch.data.common import (
    ExampleDataset,
    load_detection_pickles,
    load_image_file,
    load_object_crops,
    load_object_label_map,
    pad_stack,
    shorten_context,
)
from clip_event_tpu_torch.data.dedupe import dedupe_rows, identity_layout
from clip_event_tpu_torch.data.labels import build_label_layout
from clip_event_tpu_torch.ops.bbox import normalize_bbox
from clip_event_tpu_torch.tokenizer import CONTEXT_LENGTH, tokenize

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


class VOADescriptionDataset(ExampleDataset):
    """Contrastive fine-tune batches with hard negatives.

    Each example is one image (float32, or uint8 with `uint8_images` for
    the on-device normalize) and its D = 1 + G description token rows at
    the static width `context_cap` (0 = 77). `batch_extras` adds the label
    layout of `build_label_layout`; `finalize_batch` flattens the
    descriptions to [B·D, S] and, with `dedupe_texts`, replaces them by the
    batch's unique rows (padded to the cap) plus the inverse index.

    `load_object` adds `object_image` (float32 crops, the whole image at
    slot 0, padded to `max_objects`, default `object_topk + 1`) and
    `object_mask`, and makes `image` the float32 slot-0 crop whatever
    `uint8_images` says. `load_ie` adds `entity_text` / `event_text` (token
    rows padded to `max_entities` / `max_events`) and their masks.

    `load_sr` adds the bbox channel of the local-attention loss, from the
    detections `load_object` reads: `bbox` (normalized xyxy, the
    detections that pass the ontology and the threshold, best score first,
    padded to `max_bboxes`), `bbox_mask`, and per box the token rows of
    "An image of {label}." (`bbox_desc_text`) and of the label
    (`bbox_label_text`). Only the description channel is bucketed; it is
    deduped under `dedupe_texts`, the two bbox text channels under
    `dedupe_sr_texts` (`bbox_desc_unique` / `bbox_desc_inverse`,
    `bbox_label_unique` / `bbox_label_inverse`).

    Data parallel (`dist_rank` of `dist_world`): the labels index the
    global batch's rows and this process emits its rank's block of them
    (`data/labels.py`); a deduped channel holds the rank's cap / world
    unique rows, its inverse index offset by rank · cap / world
    (`data/dedupe.py`), and an overflow raises."""

    def __init__(
        self,
        posneg_descriptions_json: str,
        image_caption_jsons: Sequence[str],
        image_dirs: Sequence[str],
        contrastive_loss: str = "ce",
        overbatch: bool = True,
        image_size: int = 224,
        context_cap: int = 0,
        dedupe_texts: int = 0,
        dedupe_strict: bool = False,
        uint8_images: bool = False,
        load_object: bool = False,
        object_pickles: Optional[Sequence[str]] = None,
        object_ontology_file: Optional[str] = None,
        object_detection_threshold: float = 0.2,
        object_topk: int = 50,
        max_objects: Optional[int] = None,  # cap incl. the whole-image slot 0
        load_ie: bool = False,
        input_entities: Optional[Sequence[str]] = None,
        input_events: Optional[Sequence[str]] = None,
        max_entities: int = 16,
        max_events: int = 8,
        load_sr: bool = False,
        max_bboxes: int = 8,
        dedupe_sr_texts: int = 0,
        dist_rank: int = 0,
        dist_world: int = 1,
    ):
        self.image_size = image_size
        self.uint8_images = bool(uint8_images)
        self.contrastive_loss = contrastive_loss
        self.overbatch = overbatch
        self.context = int(context_cap) or CONTEXT_LENGTH
        self.dedupe_texts = int(dedupe_texts)
        self.dedupe_sr_texts = int(dedupe_sr_texts)
        self.dist_rank = int(dist_rank)
        self.dist_world = int(dist_world)
        # an overflow's fallback changes the batch shape, which the ranks'
        # blocks of the global unique rows cannot take: strict then
        self.dedupe_strict = bool(dedupe_strict) or self.dist_world > 1
        for cap in (self.dedupe_texts, self.dedupe_sr_texts):
            if cap and cap % self.dist_world:
                raise ValueError(f"dedupe cap {cap} must divide by world size {self.dist_world}")
        self.load_sr = bool(load_sr)
        self.max_bboxes = max_bboxes

        self._descriptions_json = posneg_descriptions_json
        with open(posneg_descriptions_json) as fh:
            descriptions = json.load(fh)

        self.data = []
        for rec in load_image_caption_pairs(image_caption_jsons, image_dirs):
            desc = descriptions.get(rec["image_id"])
            if desc is None:
                continue
            rec["pos"] = desc["pos"]
            rec["neg_event"] = desc["neg_event"]
            rec["neg_argument"] = desc.get("neg_argument", desc["neg_event"])
            self.data.append(rec)
        if not self.data:
            raise ValueError("no images matched the descriptions json")

        first = self.data[0]
        self.num_pos = len(first["pos"])
        self.num_neg = len(first["neg_event"]) + len(first["neg_argument"])
        self.num_desc = self.num_pos + self.num_neg
        log.info(
            "Loaded %d instances (%d descriptions each) from %s",
            len(self.data), self.num_desc, image_caption_jsons,
        )
        if self.context < CONTEXT_LENGTH:
            # the truncation cost of the cap, on a uniform sample
            pick = np.random.default_rng(0).choice(
                len(self.data), size=min(512, len(self.data)), replace=False
            )
            sample = [t for i in pick for t in self._texts(self.data[i])]
            eot = np.argmax(tokenize(sample), axis=-1)
            frac = float(np.mean(eot >= self.context))
            (log.warning if frac > 0.05 else log.info)(
                "context_cap=%d: %.1f%% of %d uniformly sampled descriptions "
                "exceed the cap (truncate-keep-EOT applies to those)",
                self.context, 100.0 * frac, len(sample),
            )

        self.load_object = bool(load_object)
        if self.load_object or self.load_sr:
            self.object_threshold = object_detection_threshold
            self.object_topk = object_topk
            self.max_objects = max_objects or (object_topk + 1)
            self.object_labels = load_object_label_map(object_ontology_file)
            self.object_results = load_detection_pickles(object_pickles or [])

        self.load_ie = bool(load_ie)
        if self.load_ie:
            self.max_entities = max_entities
            self.max_events = max_events
            self.ie: IEIndex = load_ie_index(input_entities, input_events)

    @staticmethod
    def _texts(rec) -> List[str]:
        return list(rec["pos"]) + list(rec["neg_event"]) + list(rec["neg_argument"])

    def __len__(self):
        return len(self.data)

    def _widths_sidecar(self) -> str:
        return f"{self._descriptions_json}.widths{self.context}.npz"

    def instance_widths(self, num_workers: int = 0) -> np.ndarray:
        """Per-instance minimal text width: max EOT index + 1 over the
        instance's descriptions (config "length_buckets"). The BPE pass is
        O(corpus), so it persists to a sidecar
        `<descriptions_json>.widths<context>.npz` keyed on the json's
        mtime+size, memoizes per unique string, and splits across
        `num_workers` threads."""
        cached = getattr(self, "_instance_widths", None)
        if cached is not None:
            return cached
        try:
            stat = os.stat(self._descriptions_json)
            key = (int(stat.st_mtime_ns), int(stat.st_size), self.context)
        except OSError:
            key = None
        sidecar = self._widths_sidecar()
        if key is not None and os.path.exists(sidecar):
            try:
                with np.load(sidecar, allow_pickle=False) as blob:
                    if tuple(int(x) for x in blob["key"]) == key:
                        by_id = dict(zip(blob["image_ids"].tolist(), blob["widths"].tolist()))
                        widths = [by_id.get(rec["image_id"]) for rec in self.data]
                        if all(w is not None for w in widths):
                            self._instance_widths = np.asarray(widths, np.int32)
                            return self._instance_widths
            except (OSError, KeyError, ValueError):
                log.warning("unreadable widths sidecar %s: recomputing", sidecar)

        memo: dict = {}  # unique description string → token width

        def width_of(texts):
            missing = [t for t in texts if t not in memo]
            if missing:
                tok = tokenize(missing, self.context)
                for t, w in zip(missing, np.argmax(tok, axis=-1) + 1):
                    memo[t] = int(w)
            return max(memo[t] for t in texts)

        def compute(indices):
            return np.asarray([width_of(self._texts(self.data[i])) for i in indices], np.int32)

        cached = np.empty(len(self.data), np.int32)
        if num_workers and num_workers > 1 and len(self.data) > 2 * num_workers:
            from concurrent.futures import ThreadPoolExecutor

            strides = [list(range(w, len(self.data), num_workers)) for w in range(num_workers)]
            with ThreadPoolExecutor(num_workers) as pool:
                for idxs, out in zip(strides, pool.map(compute, strides)):
                    cached[idxs] = out
        else:
            cached = compute(range(len(self.data)))
        self._instance_widths = cached
        if key is not None:
            try:
                np.savez(
                    sidecar, key=np.asarray(key, np.int64),
                    image_ids=np.asarray([rec["image_id"] for rec in self.data]),
                    widths=cached,
                )
            except OSError:
                log.info("widths sidecar not writable (%s): skipping", sidecar)
        return cached

    def apply_bucket(self, tensors: dict, width: int) -> dict:
        """Slice the description channel to the batch's bucket width. Every
        instance in the batch has EOT < width (loader invariant), so the
        narrower layout encodes identically; the unique rows of dedupe slice
        the same way."""
        for key in ("text", "text_unique"):
            if key in tensors:
                tensors[key] = np.ascontiguousarray(tensors[key][..., :width])
        return tensors

    def __getitem__(self, idx: int):
        inst = self.data[idx]
        image_id = inst["image_id"]
        path = os.path.join(inst["image_dir"], image_id + ".jpg")
        texts = self._texts(inst)
        tensors = {"text": tokenize(texts, self.context)}
        meta = {"image_id": image_id, "descriptions": texts}

        if self.load_object:
            crops, obj_ids, obj_labels = load_object_crops(
                path, self.object_results.get(image_id, []), self.object_labels,
                threshold=self.object_threshold,
                topk=min(self.object_topk, self.max_objects - 1), size=self.image_size,
            )
            tensors["image"] = crops[0]
            n = min(len(crops), self.max_objects)
            tensors["object_image"] = pad_stack(list(crops), self.max_objects)
            mask = np.zeros(self.max_objects, np.int32)
            mask[:n] = 1
            tensors["object_mask"] = mask
            meta["object_ids"] = obj_ids[: self.max_objects]
            meta["object_labels"] = obj_labels[: self.max_objects]
        else:
            tensors["image"] = load_image_file(path, self.image_size, raw=self.uint8_images)

        if self.load_ie:
            ent_names = doc_entity_names(self.ie, image_id)[: self.max_entities]
            evt_names = doc_event_names(self.ie, image_id)[: self.max_events]
            C = self.context
            for field, names, cap in (("entity", ent_names, self.max_entities),
                                      ("event", evt_names, self.max_events)):
                tok = tokenize(names, C) if names else np.zeros((0, C), np.int32)
                tensors[f"{field}_text"] = pad_stack(list(tok), cap, pad_shape=(C,)).astype(np.int32)
                mask = np.zeros(cap, np.int32)
                mask[: len(names)] = 1
                tensors[f"{field}_mask"] = mask
            meta["entity_names"] = ent_names
            meta["event_names"] = evt_names
        if self.load_sr:
            tensors.update(self._sr_channel(path, image_id))
        return tensors, meta

    def _sr_channel(self, path: str, image_id: str) -> dict:
        """Normalized detection boxes and their label texts, padded to
        `max_bboxes`."""
        R = self.max_bboxes
        bboxes = np.zeros((R, 4), np.float32)
        mask = np.zeros(R, np.int32)
        desc_tok = np.zeros((R, self.context), np.int32)
        label_tok = np.zeros((R, self.context), np.int32)
        dets = [
            d for d in sorted(self.object_results.get(image_id, []), key=itemgetter("score"),
                              reverse=True)
            if d["label"] in self.object_labels and d["score"] >= self.object_threshold
        ][:R]
        if dets:
            if "bbox_normalized" in dets[0]:
                boxes = [list(d["bbox_normalized"]) for d in dets]
            else:
                from PIL import Image

                with Image.open(path) as img:
                    width, height = img.size
                boxes = [list(normalize_bbox(d["bbox"], width, height)) for d in dets]
            labels = [self.object_labels[d["label"]] for d in dets]
            bboxes[: len(dets)] = np.asarray(boxes, np.float32)
            mask[: len(dets)] = 1
            desc_tok[: len(dets)] = tokenize([f"An image of {lb.lower()}." for lb in labels],
                                             self.context)
            label_tok[: len(dets)] = tokenize([lb.lower() for lb in labels], self.context)
        return {"bbox": bboxes, "bbox_mask": mask, "bbox_desc_text": desc_tok,
                "bbox_label_text": label_tok}

    def batch_extras(self, batch_size: int):
        layout = build_label_layout(
            batch_size, self.num_pos, self.num_neg, self.contrastive_loss, self.overbatch,
            rank=self.dist_rank, world_size=self.dist_world,
        )
        return {
            "labels_per_image": layout.labels_per_image,
            "labels_per_text": layout.labels_per_text,
            "index_pos": layout.index_pos,
        }

    def finalize_batch(self, tensors):
        # flatten descriptions: [B, D, S] → [B·D, S] (dataset_voa.py:605-612)
        tensors["text"] = tensors["text"].reshape(-1, tensors["text"].shape[-1])
        if self.dedupe_texts:
            self._dedupe_field(tensors, "text", "text", self.dedupe_texts)
        if self.dedupe_sr_texts and self.load_sr:
            self._dedupe_field(tensors, "bbox_desc_text", "bbox_desc", self.dedupe_sr_texts)
            self._dedupe_field(tensors, "bbox_label_text", "bbox_label", self.dedupe_sr_texts)
        return tensors

    def _dedupe_field(self, tensors: dict, field: str, prefix: str, cap: int) -> None:
        """Replace `field` by `{prefix}_unique` + `{prefix}_inverse`; a
        non-strict overflow takes the undeduped layout, a new shape."""
        rows = tensors.pop(field)
        rows = rows.reshape(-1, rows.shape[-1])
        out = dedupe_rows(rows, cap, rank=self.dist_rank, world=self.dist_world,
                          strict=self.dedupe_strict, tag=field)
        tensors[f"{prefix}_unique"], tensors[f"{prefix}_inverse"] = (
            identity_layout(rows, rank=self.dist_rank) if out is None else out
        )
