"""Zero-shot M2E2 multimedia event extraction (counterpart of
`clip_event_tpu/evals/m2e2.py`).

Primary metrics, the M2E2 benchmark's per-mention protocol (Li et al., ACL
2020, §5.1; the CLIP-Event paper's zero-shot M2E2 numbers use it):

  * An image event MENTION is an (image, event_type) prediction, correct
    iff the image's gold annotation has a mention of that type (one-to-one:
    k predicted mentions of a type count at most min(k, gold count)).
  * precision = #correct / #predicted, recall = #correct / #gold, F1 =
    2PR/(P+R). Event-free images carry no gold mentions.
  * An ARGUMENT mention is an (image, event_type, role, box) prediction,
    correct iff the image's gold mention of that type has that role with a
    box at IoU >= 0.5, matched one-to-one.

Prediction: argmax of the cosine similarity between the image embedding
and each event type's template embedding; with `null_threshold`, an image
whose top softmax probability (over 100·cosine) is below it predicts no
mention. Secondary fields: image-level accuracy and macro P/R/F1 over
event types, on event-bearing images.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from clip_event_tpu_torch.data.m2e2 import M2E2Dataset
from clip_event_tpu_torch.evals.common import (
    Encoders,
    eval_loader,
    genuine_rows,
    macro_prf,
    resolve_shard,
)
from clip_event_tpu_torch.ops.bbox import iou
from clip_event_tpu_torch.parallel.collectives import all_gather_objects


def prf(correct: int, n_pred: int, n_gold: int) -> Dict[str, float]:
    p = correct / n_pred if n_pred else 0.0
    r = correct / n_gold if n_gold else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return {"precision": p, "recall": r, "f1": f}


def event_mention_counts(pred: Iterable[str], gold: Iterable[str]) -> Tuple[int, int, int]:
    """One image's (correct, n_pred, n_gold) under one-to-one type matching."""
    pc, gc = Counter(pred), Counter(gold)
    correct = sum(min(n, gc[t]) for t, n in pc.items())
    return correct, sum(pc.values()), sum(gc.values())


def event_mention_prf(
    pred_mentions: Dict[str, List[str]], gold_mentions: Dict[str, List[str]]
) -> Dict[str, float]:
    """Corpus-level event-extraction P/R/F1. Both dicts map image_id → list
    of event types (empty/absent = no mentions)."""
    correct = n_pred = n_gold = 0
    for image_id in set(pred_mentions) | set(gold_mentions):
        c, p, g = event_mention_counts(
            pred_mentions.get(image_id, ()), gold_mentions.get(image_id, ())
        )
        correct += c
        n_pred += p
        n_gold += g
    return prf(correct, n_pred, n_gold)


def argument_counts(pred: Iterable, gold: Iterable, iou_threshold: float = 0.5) -> Tuple[int, int, int]:
    """One image's argument (correct, n_pred, n_gold). Each mention is
    (event_type, role, xyxy box); a prediction is correct iff some unmatched
    gold argument has the same type and role and IoU >= threshold (greedy,
    in prediction order)."""
    gold = list(gold)
    matched = [False] * len(gold)
    correct = n_pred = 0
    for (pt, pr, pb) in pred:
        n_pred += 1
        for j, (gt, gr, gb) in enumerate(gold):
            if matched[j] or gt != pt or gr != pr:
                continue
            if iou(pb, gb) >= iou_threshold:
                matched[j] = True
                correct += 1
                break
    return correct, n_pred, len(gold)


def argument_prf(pred_args: Dict[str, list], gold_args: Dict[str, list],
                 iou_threshold: float = 0.5) -> Dict[str, float]:
    """Corpus-level argument-extraction P/R/F1. Both dicts map image_id →
    list of (event_type, role, xyxy box)."""
    correct = n_pred = n_gold = 0
    for image_id in set(pred_args) | set(gold_args):
        c, p, g = argument_counts(
            pred_args.get(image_id, ()), gold_args.get(image_id, ()), iou_threshold
        )
        correct += c
        n_pred += p
        n_gold += g
    return prf(correct, n_pred, n_gold)


def sweep_null_threshold(
    top_probs: np.ndarray, top_correct: np.ndarray, n_gold: int
) -> Tuple[Optional[float], float]:
    """(threshold, event_f1) maximizing event F1 when each image predicts
    its top type iff its top softmax prob >= threshold. Exact, O(N log N):
    every prefix of the probs sorted descending is a realizable prediction
    set (tied probs stay together). (None, f1) when predicting everything
    is best."""
    top_probs = np.asarray(top_probs, np.float64)
    top_correct = np.asarray(top_correct, bool)
    if not len(top_probs):
        return None, 0.0
    order = np.argsort(-top_probs, kind="stable")
    probs = top_probs[order]
    cum_correct = np.cumsum(top_correct[order]).astype(np.float64)
    n_pred = np.arange(1, len(probs) + 1, dtype=np.float64)
    p = cum_correct / n_pred
    r = cum_correct / n_gold if n_gold else np.zeros_like(cum_correct)
    with np.errstate(invalid="ignore"):
        f1 = np.where(p + r > 0, 2 * p * r / (p + r), 0.0)
    # realizable cut points: the last index of each tied-prob run
    realizable = np.append(probs[1:] != probs[:-1], True)
    f1 = np.where(realizable, f1, -1.0)
    k = int(np.argmax(f1))
    if k == len(probs) - 1:
        return None, float(f1[k])
    return float(probs[k]), float(f1[k])


def _event_counts_at(threshold, top_probs, img_correct, n_gold):
    pred = np.ones(len(top_probs), bool) if threshold is None else top_probs >= threshold
    return int((pred & img_correct).sum()), int(pred.sum()), int(n_gold), pred


def _gold_argument_mentions(mentions: list) -> list:
    out = []
    for m in mentions:
        for role, boxes in m.get("arguments", {}).items():
            boxes = boxes if boxes and hasattr(boxes[0], "__len__") else [boxes]
            for box in boxes:
                out.append((m["event_type"], role, box))
    return out


def evaluate_m2e2(
    params,
    cfg,
    dataset: M2E2Dataset,
    batch_size: int = 32,
    null_threshold: Optional[float] = None,
    ground_arguments: bool = False,
    arg_topk: int = 4,
    iou_threshold: float = 0.5,
    select_null_threshold: bool = False,
    device="cuda",
    rank=None,
    world_size=None,
) -> dict:
    """Event-extraction P/R/F1 (primary), the image-level accuracy and
    macro fields (secondary) and a per-event-type breakdown (`per_type`).

    `ground_arguments=True` also predicts arguments zero-shot for every
    role the ontology declares on the predicted type: the role description
    is grounded to the top-k patch-window box of the ViT grid
    (`evals.gsr.window_boxes`) and scored by argument P/R/F1. Needs role
    descriptions in the ontology and a ViT tower.

    `select_null_threshold=True` picks the threshold by the exact F1 sweep
    on the even dataset indices and reports the primary metrics on the odd
    ones at that threshold (`null_threshold_selected`, `dev_event_f1`);
    `null_threshold` is then ignored. It cannot be combined with
    `ground_arguments` (arguments are predicted before the threshold is
    known): run the sweep first, then pass the selected value.

    Sharded by rank (`resolve_shard`): each rank scores its slice, and one
    all-gather brings every rank the per-image records and the argument
    counts, so every rank returns the full-set metrics."""
    if select_null_threshold and ground_arguments:
        raise ValueError(
            "select_null_threshold is incompatible with ground_arguments: "
            "run the sweep first, then pass null_threshold=<selected>"
        )
    from clip_event_tpu_torch.tokenizer import tokenize

    rank, world_size = resolve_shard(rank, world_size)
    loader = eval_loader(dataset, batch_size, rank=rank, world_size=world_size)
    enc = Encoders(params, cfg, batch_size=batch_size, device=device)
    cand_feats = enc.texts(dataset.candidate_tokens)  # [T, E]

    grid_fn = None
    role_feats_by_type: Dict[str, tuple] = {}
    if ground_arguments:
        if not cfg.is_vit:
            raise ValueError("ground_arguments needs a ViT vision tower")
        if not any(dataset.role_descriptions.values()):
            raise ValueError(
                "ground_arguments needs role descriptions in the ontology "
                "json ({type: {template, roles: {role: desc}}})"
            )
        from clip_event_tpu_torch.evals.gsr import _grid_features_fn, window_boxes

        grid_fn = _grid_features_fn(cfg)
        for etype, roles in dataset.role_descriptions.items():
            if roles:
                names = list(roles)
                role_feats_by_type[etype] = (names, enc.texts(tokenize([roles[r] for r in names])))

    # per-image records (the event side, for the threshold sweep and the
    # per-type breakdown) and additive argument counts: both exact under a
    # sharded eval (gathered below)
    img_gidx: List[int] = []  # global dataset index
    img_top_prob: List[float] = []
    img_top_idx: List[int] = []
    img_correct: List[bool] = []  # top type present in this image's gold
    img_gold: List[List[str]] = []  # gold event types per image
    arg_correct = arg_pred = arg_gold = 0
    sec_pred, sec_gold = [], []  # secondary per-image arrays (positives)
    offset = 0
    for batch, metas_b in loader:
        images = np.asarray(batch["image"])
        b = images.shape[0]
        gidx_b = rank + (offset + np.arange(b)) * world_size
        genuine = genuine_rows(rank, world_size, offset, b, len(dataset))
        offset += b
        feats = enc.images(images)  # [b, E]
        logits = 100.0 * feats @ cand_feats.T
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        top = logits.argmax(axis=1)
        grid_feats = None if grid_fn is None else grid_fn(enc.params, images)[:, 1:]  # drop CLS

        for i in range(b):
            if not genuine[i]:
                continue
            gold_types = [m["event_type"] for m in metas_b[i]["mentions"]]
            predicted = null_threshold is None or probs[i, top[i]] >= null_threshold
            pred_types = [dataset.event_types[top[i]]] if predicted else []
            img_gidx.append(int(gidx_b[i]))
            img_top_prob.append(float(probs[i, top[i]]))
            img_top_idx.append(int(top[i]))
            img_correct.append(dataset.event_types[top[i]] in gold_types)
            img_gold.append(gold_types)
            if gold_types:
                sec_gold.append(dataset.event_type_to_idx[gold_types[0]])
                sec_pred.append(int(top[i]))

            if grid_fn is None:
                continue
            gold_args = _gold_argument_mentions(metas_b[i]["mentions"])
            pred_args = []
            if predicted and pred_types[0] in role_feats_by_type:
                names, rfeats = role_feats_by_type[pred_types[0]]
                heat = rfeats @ grid_feats[i].T  # [R, G²]
                boxes = window_boxes(heat[None], cfg.grid_size, arg_topk)[0]  # [R, 4]
                pred_args = [(pred_types[0], names[j], boxes[j]) for j in range(len(names))]
            c, p, g = argument_counts(pred_args, gold_args, iou_threshold)
            arg_correct += c
            arg_pred += p
            arg_gold += g

    sec_pred = np.asarray(sec_pred, np.int64)
    sec_gold = np.asarray(sec_gold, np.int64)
    img_gidx = np.asarray(img_gidx, np.int64)
    img_top_prob = np.asarray(img_top_prob, np.float64)
    img_top_idx = np.asarray(img_top_idx, np.int64)
    img_correct = np.asarray(img_correct, bool)
    if world_size > 1:
        # one gather: the per-image event records, the additive argument
        # counts and the secondary per-image arrays
        parts = all_gather_objects(
            (img_gidx, img_top_prob, img_top_idx, img_correct, img_gold,
             arg_correct, arg_pred, arg_gold, sec_pred, sec_gold)
        )
        img_gidx, img_top_prob, img_top_idx, img_correct = (
            np.concatenate([c[k] for c in parts]) for k in range(4))
        img_gold = [g for c in parts for g in c[4]]
        arg_correct, arg_pred, arg_gold = (sum(c[k] for c in parts) for k in range(5, 8))
        sec_pred, sec_gold = (np.concatenate([c[k] for c in parts]) for k in (8, 9))
    img_n_gold = np.array([len(g) for g in img_gold], np.int64)

    metrics = {}
    eval_mask = np.ones(len(img_gidx), bool)
    if select_null_threshold:
        # sweep on the even-index dev half; the primary metrics on the
        # held-out odd half at the selected threshold
        dev = img_gidx % 2 == 0
        null_threshold, dev_f1 = sweep_null_threshold(
            img_top_prob[dev], img_correct[dev], int(img_n_gold[dev].sum())
        )
        eval_mask = ~dev
        metrics["null_threshold_selected"] = null_threshold
        metrics["dev_event_f1"] = dev_f1
        metrics["dev_images"] = int(dev.sum())
    ev_correct, ev_pred, ev_gold, pred_mask = _event_counts_at(
        null_threshold, img_top_prob[eval_mask], img_correct[eval_mask],
        int(img_n_gold[eval_mask].sum()),
    )
    metrics.update({f"event_{k}": v for k, v in prf(ev_correct, ev_pred, ev_gold).items()})
    metrics.update({
        "event_mentions_gold": int(ev_gold),
        "event_mentions_pred": int(ev_pred),
        "num_images": int(len(dataset)),
        "eval_images": int(eval_mask.sum()),
    })
    # per-event-type breakdown at the effective threshold (over eval images)
    gold_type_counts = Counter(t for keep, g in zip(eval_mask, img_gold) if keep for t in g)
    top_eval, correct_eval = img_top_idx[eval_mask], img_correct[eval_mask]
    per_type = {}
    for t, name in enumerate(dataset.event_types):
        sel = pred_mask & (top_eval == t)
        g = gold_type_counts.get(name, 0)
        if not sel.any() and not g:
            continue
        per_type[name] = prf(int((sel & correct_eval).sum()), int(sel.sum()), g)
        per_type[name]["gold"] = int(g)
    metrics["per_type"] = per_type
    if ground_arguments:
        metrics.update({f"argument_{k}": v for k, v in prf(arg_correct, arg_pred, arg_gold).items()})
        metrics["argument_mentions_gold"] = int(arg_gold)
        metrics["argument_mentions_pred"] = int(arg_pred)

    if len(sec_gold):
        metrics["accuracy"] = float((sec_pred == sec_gold).mean())
        metrics.update(macro_prf(sec_gold, sec_pred, len(dataset.event_types)))
    return metrics
