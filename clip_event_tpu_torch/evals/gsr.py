"""Zero-shot GSR/SWiG: verb classification and argument grounding
(counterpart of `clip_event_tpu/evals/gsr.py`; entry point
`eval_gsr.py`).

Verb: the image embedding against the candidate-verb text matrix →
top-1/top-5. Grounding: for each annotated role, a similarity heat map
between the role description's embedding and the ViT grid-token
embeddings picks the best patch window (the union box of its top-k cells),
correct when its IoU with the gold box is ≥ 0.5 (`utils_image.py:65-73`);
or, with `ground_via="objects"`, the detected box whose window-pooled grid
feature is closest to the role. The M2E2 eval grounds its argument roles
with the same helpers. One pass over the loader; per batch one image
encode, one grid encode and one role-text encode ([b·R, S]), and the
heat-map and IoU scoring vectorized on the host. Sharded by rank
(`resolve_shard`): the verb features are merged back into dataset order,
the grounding and value counts summed, and every rank returns the full-set
metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from clip_event_tpu_torch.data.sr import GSRDataset
from clip_event_tpu_torch.evals.common import (
    Encoders,
    eval_loader,
    genuine_rows,
    merge_across_ranks,
    resolve_shard,
)
from clip_event_tpu_torch.models import clip as clip_model
from clip_event_tpu_torch.models.local_attention import pool_bbox_features
from clip_event_tpu_torch.ops.bbox import iou_batch
from clip_event_tpu_torch.parallel.collectives import all_gather_objects


def _grid_features_fn(cfg, compute_dtype=None):
    """fn(params, images numpy [B, H, W, 3]) → l2-normalized grid features
    [B, grid²+1, E] (CLS first) as numpy, encoded on the params' device."""
    dtype = compute_dtype or torch.float32

    def fn(params, images):
        device = params["logit_scale"].device
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            feats = clip_model.encode_image(params, cfg, x, use_grid=True, compute_dtype=dtype)
            return clip_model.l2_normalize(feats).float().cpu().numpy()

    return fn


def window_boxes(heat: np.ndarray, grid: int, topk: int = 1) -> np.ndarray:
    """Vectorized: [..., G²] heat maps → [..., 4] union bbox of the top-k
    grid cells, in normalized coords."""
    k = min(topk, heat.shape[-1])
    top = np.argpartition(-heat, k - 1, axis=-1)[..., :k]
    rows, cols = top // grid, top % grid
    return np.stack(
        [
            cols.min(axis=-1) / grid,
            rows.min(axis=-1) / grid,
            (cols.max(axis=-1) + 1) / grid,
            (rows.max(axis=-1) + 1) / grid,
        ],
        axis=-1,
    ).astype(np.float32)


def patch_window_bbox(heat: np.ndarray, grid: int, topk: int = 1) -> list:
    """Single-heat-map convenience wrapper around `window_boxes`."""
    return list(window_boxes(heat.reshape(-1), grid, topk))


def _pad_object_boxes(metas_b, b):
    """Per-image detected boxes (ragged) → padded [b, K, 4] + mask."""
    boxes_list = [m.get("object_bboxes", []) or [] for m in metas_b]
    K = max((len(x) for x in boxes_list), default=0)
    if K == 0:
        return None, None
    box_arr = np.zeros((b, K, 4), np.float32)
    box_mask = np.zeros((b, K), np.int32)
    for i, bl in enumerate(boxes_list):
        if bl:
            box_arr[i, : len(bl)] = np.asarray(bl, np.float32)
            box_mask[i, : len(bl)] = 1
    return box_arr, box_mask


def _pooled(grid_feats, boxes, mask, grid, device) -> np.ndarray:
    """l2-normalized window means of the grid features over each box."""
    with torch.inference_mode():
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (grid_feats, boxes, mask)]
        pooled = pool_bbox_features(t[0], t[1], t[2], grid)
        return clip_model.l2_normalize(pooled, eps=1e-8).cpu().numpy()


def evaluate_gsr(
    params,
    cfg,
    dataset: GSRDataset,
    batch_size: int = 32,
    ground_topk: int = 4,
    iou_threshold: float = 0.5,
    ground_via: str = "grid",
    value_metrics: bool = True,
    device="cuda",
    rank=None,
    world_size=None,
) -> dict:
    """ground_via: 'grid' predicts a top-k patch-window box from the role →
    grid-token heat map; 'objects' ranks the detected object boxes by the
    similarity between the role description and each box's window-pooled
    grid feature (needs `dataset.load_object`).

    With `value_metrics` (a ViT tower), also the situation-recognition
    noun metrics of imSitu and SWiG: value (annotated roles whose predicted
    noun is the gold majority gloss), value_all (frames with every
    annotated role's noun right), grounded_value[_all] (the predicted box
    must also reach IoU ≥ `iou_threshold`; a role with no gold box needs
    only the noun). The noun is predicted zero-shot from the predicted
    box's window-pooled grid feature against "An image of {noun}." over the
    glosses of the annotations; roles with no gold noun are left out. A
    ResNet tower has no grid tokens: it gets the verb metrics only, as in
    JAX."""
    do_grounding = cfg.is_vit
    if do_grounding and ground_via == "objects" and not dataset.load_object:
        raise ValueError("ground_via='objects' needs dataset.load_object=True")

    rank, world_size = resolve_shard(rank, world_size)
    loader = eval_loader(dataset, batch_size, rank=rank, world_size=world_size)
    enc = Encoders(params, cfg, batch_size=batch_size, device=device)
    grid = cfg.grid_size if do_grounding else None
    grid_fn = _grid_features_fn(cfg) if do_grounding else None

    do_value = value_metrics and do_grounding
    noun_feats = noun_index = None
    if do_value:
        from clip_event_tpu_torch.tokenizer import tokenize

        vocab = sorted({n for inst in dataset.data for n in inst["noun_types"] if n})
        if vocab:
            noun_index = {n: i for i, n in enumerate(vocab)}
            noun_feats = enc.texts(tokenize([f"An image of {n}." for n in vocab]))  # [V, E]
        else:
            do_value = False

    image_feats, gold_verbs = [], []
    hits, total = 0, 0
    v_hits = v_total = va_hits = va_total = gv_hits = gva_hits = 0
    offset = 0  # local example index, for the wrap-around rows' mask
    for batch, metas_b in loader:
        images = np.asarray(batch["image"])
        b = images.shape[0]
        # the loader's count-equalizing duplicates stay out of the streamed
        # counts (the per-example arrays are deduped by merge_across_ranks)
        genuine = genuine_rows(rank, world_size, offset, b, len(dataset))
        offset += b
        image_feats.append(enc.images(images))
        gold_verbs.append(np.asarray(batch["verb_idx"]))
        if not do_grounding:
            continue

        grid_feats = grid_fn(enc.params, images)[:, 1:]  # [b, G², E], CLS dropped
        role_text = np.asarray(batch["role_text"])  # [b, R, S]
        R = role_text.shape[1]
        role_feats = enc.texts(role_text.reshape(b * R, -1)).reshape(b, R, -1)
        role_mask = np.asarray(batch["role_mask"]).astype(bool)  # [b, R]
        role_bbox = np.asarray(batch["role_bbox"], np.float32)  # [b, R, 4]
        valid = role_mask & (role_bbox[..., 0] >= 0) & genuine[:, None]

        if ground_via == "objects":
            box_arr, box_mask = _pad_object_boxes(metas_b, b)
            if box_arr is None:
                continue
            box_feats = _pooled(grid_feats, box_arr, box_mask, grid, enc.device)  # [b, K, E]
            scores = np.einsum("bre,bke->brk", role_feats, box_feats)
            scores = np.where(box_mask[:, None, :] > 0, scores, -np.inf)
            pred_boxes = box_arr[np.arange(b)[:, None], scores.argmax(-1)]  # [b, R, 4]
            valid &= box_mask.any(-1)[:, None]
        else:
            heat = np.einsum("bre,bge->brg", role_feats, grid_feats)  # [b, R, G²]
            pred_boxes = window_boxes(heat, grid, ground_topk)  # [b, R, 4]

        ious = iou_batch(pred_boxes, role_bbox)
        hits += int(((ious >= iou_threshold) & valid).sum())
        total += int(valid.sum())

        if do_value:
            pooled = _pooled(grid_feats, np.clip(pred_boxes, 0.0, 1.0),
                             role_mask.astype(np.int32), grid, enc.device)  # [b, R, E]
            noun_pred = (pooled @ noun_feats.T).argmax(-1)  # [b, R]
            for i in range(b):
                if not genuine[i]:
                    continue
                nouns = metas_b[i]["noun_types"][:R]
                annotated = [j for j, n in enumerate(nouns) if n and role_mask[i, j]]
                if not annotated:
                    continue
                va_total += 1
                all_ok = all_gok = True
                for j in annotated:
                    ok = bool(noun_pred[i, j] == noun_index[nouns[j]])
                    has_box = role_bbox[i, j, 0] >= 0
                    gok = ok and (not has_box or ious[i, j] >= iou_threshold)
                    v_total += 1
                    v_hits += ok
                    gv_hits += gok
                    all_ok &= ok
                    all_gok &= gok
                va_hits += all_ok
                gva_hits += all_gok

    image_feats, gold = merge_across_ranks(
        len(dataset), world_size, np.concatenate(image_feats), np.concatenate(gold_verbs)
    )
    if world_size > 1:
        counts = all_gather_objects((hits, total, v_hits, v_total, va_hits, va_total, gv_hits, gva_hits))
        hits, total, v_hits, v_total, va_hits, va_total, gv_hits, gva_hits = (
            sum(c[k] for c in counts) for k in range(8))
    cand_feats = enc.texts(dataset.candidate_tokens)
    logits = image_feats @ cand_feats.T
    order = np.argsort(-logits, axis=1)
    metrics = {
        "verb_top1": float((order[:, 0] == gold).mean()),
        "verb_top5": float((order[:, :5] == gold[:, None]).any(axis=1).mean()),
        "num_images": int(len(gold)),
    }
    if do_grounding:
        metrics["grounding_acc"] = hits / total if total else 0.0
        metrics["grounded_args"] = total
        metrics["ground_via"] = ground_via
    if do_value:
        metrics["value"] = v_hits / v_total if v_total else 0.0
        metrics["value_all"] = va_hits / va_total if va_total else 0.0
        metrics["grounded_value"] = gv_hits / v_total if v_total else 0.0
        metrics["grounded_value_all"] = gva_hits / va_total if va_total else 0.0
        metrics["value_roles"] = int(v_total)
        metrics["value_frames"] = int(va_total)
    return metrics
