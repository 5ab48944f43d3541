"""Salient-event selection (the port's counterpart of
`clip_event_tpu/preprocess/selection.py`; reference
`preprocess_description_contrastive.py:116-282`).

Per caption, rank candidate events by (1) event-type frequency among the
caption's events, (2) argument count, (3) CLIP image–event-type similarity
(exact type +10·score, same parent +5·score, mismatch −10·score), then merge
arguments across same-type events.

`ClipTypeScorer` encodes every uncached image and every event-type
description through the port's fp32 encoders (`evals/common.py::Encoders`)
in fixed batches of 64, under the process-wide attention choice
(`models/layers.py::set_attention_impl`): on the card every block of both
towers runs K1's forward, with no fallback. The per-doc cache JSON
({scores, pred_idx, probs}) is the JAX package's: either package reads the
other's cache, and a cached doc encodes nothing.
"""

from __future__ import annotations

import json
import logging
import os
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


class ClipTypeScorer:
    """Batched zero-shot event-type scorer with a per-doc JSON cache.

    `params` is a `CLIP` module or its param dict, `device` the card
    ("cuda", the default) or "cpu". The type descriptions are encoded once,
    here."""

    def __init__(
        self,
        params,
        model_cfg,
        type_descriptions: Dict[str, str],  # event type → description text
        cache_dir: Optional[str] = None,
        batch_size: int = 64,
        device="cuda",
    ):
        from clip_event_tpu_torch.evals.common import Encoders
        from clip_event_tpu_torch.tokenizer import tokenize

        self.id2str = list(type_descriptions.keys())
        self.str2id = {t: i for i, t in enumerate(self.id2str)}
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._enc = Encoders(params, model_cfg, batch_size=batch_size, device=device)
        self._image_size = model_cfg.image_resolution
        self._text_feats = self._enc.texts(
            tokenize([type_descriptions[t] for t in self.id2str])
        )
        self._scale = 100.0  # CLIP logit scale magnitude for softmax sharpness

    def _cache_path(self, doc_id: str) -> Optional[str]:
        return os.path.join(self.cache_dir, doc_id + ".json") if self.cache_dir else None

    def score_all(self, doc_ids: List[str], image_paths: Dict[str, str]) -> Dict[str, dict]:
        """Returns {doc_id: {scores, pred_idx, probs}}. Missing/broken images
        get pred_idx −1 (reference behaviour on exceptions)."""
        from clip_event_tpu_torch.data.common import load_image_file

        out: Dict[str, dict] = {}
        pending_ids, pending_imgs = [], []
        for doc_id in doc_ids:
            cache = self._cache_path(doc_id)
            if cache and os.path.exists(cache):
                with open(cache) as fh:
                    out[doc_id] = json.load(fh)
                continue
            path = image_paths.get(doc_id)
            try:
                pending_imgs.append(load_image_file(path, self._image_size))
                pending_ids.append(doc_id)
            except Exception:
                log.warning("could not load image for %s (%s)", doc_id, path)
                out[doc_id] = {"scores": 0.0, "pred_idx": -1, "probs": []}

        if pending_ids:
            # softmax(100 · f_img · f_txtᵀ) in fp32 numpy, as in the JAX package
            feats = self._enc.images(np.stack(pending_imgs))
            logits = self._scale * feats @ self._text_feats.T
            logits = logits - logits.max(axis=1, keepdims=True)
            probs = np.exp(logits)
            probs /= probs.sum(axis=1, keepdims=True)
            for i, doc_id in enumerate(pending_ids):
                rec = {
                    "scores": float(probs[i].max()),
                    "pred_idx": int(probs[i].argmax()),
                    "probs": probs[i].tolist(),
                }
                out[doc_id] = rec
                cache = self._cache_path(doc_id)
                if cache:
                    with open(cache, "w") as fh:
                        json.dump(rec, fh)
        return out


def rank_events(
    doc_id: str,
    store: dict,
    clip_pred: Optional[dict],
    id2str: Optional[List[str]],
) -> Optional[Tuple[str, dict]]:
    """Reference `select_postive_event` ranking (:146-199)."""
    events = store["doc_ke"][doc_id]["event"]
    if not events:
        return None
    evt_info, evt_args = store["evt_info"], store["evt_args"]
    if len(events) == 1:
        return events[0], evt_args[events[0]]

    type_counter = Counter(evt_info[e]["type"] for e in events)
    arg_num_all = sum(len(evt_args[e]) for e in events)

    ranker = defaultdict(float)
    for e in events:
        ranker[e] += type_counter[evt_info[e]["type"]] / float(len(events))
        if arg_num_all > 0:
            ranker[e] += len(evt_args[e])
        if clip_pred is not None and clip_pred["pred_idx"] != -1:
            pred_type = id2str[clip_pred["pred_idx"]]
            score = clip_pred["scores"]
            etype = evt_info[e]["type"]
            if pred_type == etype:
                ranker[e] += score * 10
            elif pred_type.split(".")[0] == etype.split(".")[0]:
                ranker[e] += score * 5
            else:
                ranker[e] -= score * 10
    best = max(sorted(ranker), key=lambda e: ranker[e])
    return best, evt_args[best]


def merge_same_type_args(doc_id: str, store: dict, best_event: str, best_args: dict) -> dict:
    """Union arguments across same-type events (:200-208)."""
    evt_info, evt_args = store["evt_info"], store["evt_args"]
    best_type = evt_info[best_event]["type"]
    merged = {role: dict(args) for role, args in best_args.items()}
    for e in store["doc_ke"][doc_id]["event"]:
        if evt_info[e]["type"] != best_type:
            continue
        for role, args in evt_args[e].items():
            for arg_id, tup in args.items():
                merged.setdefault(role, {}).setdefault(arg_id, tup)
    return merged


def select_salient_events(
    store: dict,
    scorer: Optional[ClipTypeScorer] = None,
    image_paths: Optional[Dict[str, str]] = None,
    merge_args: bool = True,
) -> dict:
    """Returns {doc_id: {event_id, event_type, event_trigger, event_args}}
    (reference `select_postive_event_all`, :210-225)."""
    doc_ids = list(store["doc_ke"].keys())
    clip_preds = (
        scorer.score_all(doc_ids, image_paths or {}) if scorer is not None else {}
    )
    id2str = scorer.id2str if scorer is not None else None

    salient = {}
    no_event = 0
    for doc_id in doc_ids:
        ranked = rank_events(doc_id, store, clip_preds.get(doc_id), id2str)
        if ranked is None:
            no_event += 1
            continue
        event_id, args = ranked
        if merge_args:
            args = merge_same_type_args(doc_id, store, event_id, args)
        salient[doc_id] = {
            "event_id": event_id,
            "event_type": store["evt_info"][event_id]["type"],
            "event_trigger": store["evt_info"][event_id].get("canonical_mention", ""),
            "event_args": args,
        }
    log.info("caption_no_event: %d caption_event: %d", no_event, len(salient))
    return salient


def preprocess_caption(image_caption_jsons: Iterable[str]) -> Dict[str, str]:
    """{doc: {idx: {cap}}} files → {image_id: cleaned caption}
    (reference `preprocess_caption`, :284-296)."""
    out = {}
    for path in image_caption_jsons:
        data = json.load(open(path))
        for doc_id in data:
            for image_idx in data[doc_id]:
                image_id = f"{doc_id}_{image_idx}".replace(".", "_")
                out[image_id] = data[doc_id][image_idx]["cap"].replace("FILE - ", "")
    return out
