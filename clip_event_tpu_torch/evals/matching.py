"""Zero-shot image↔caption matching (counterpart of
`clip_event_tpu/evals/matching.py`).

Every image is scored against every caption in the split; top-1/top-5
matching accuracy both directions. Works for any dataset yielding one
`image` + one `text` per example (VOACaptionDataset, MEEDDataset).
"""

from __future__ import annotations

import numpy as np

from clip_event_tpu_torch.evals.common import (
    Encoders,
    collect_encoded,
    eval_loader,
    merge_across_ranks,
    resolve_shard,
)


def matching_metrics(image_feats: np.ndarray, text_feats: np.ndarray) -> dict:
    """Top-1/top-5 accuracy both ways for N paired, normalized features."""
    logits = image_feats @ text_feats.T  # [N, N]
    gold = np.arange(logits.shape[0])

    def topk_acc(order, k):
        return float((order[:, :k] == gold[:, None]).any(axis=1).mean())

    i2t = np.argsort(-logits, axis=1)
    t2i = np.argsort(-logits.T, axis=1)
    return {
        "i2t_top1": topk_acc(i2t, 1),
        "i2t_top5": topk_acc(i2t, 5),
        "t2i_top1": topk_acc(t2i, 1),
        "t2i_top5": topk_acc(t2i, 5),
        "num_pairs": int(logits.shape[0]),
    }


def evaluate_matching(params, cfg, dataset, batch_size: int = 32, device="cuda",
                      rank=None, world_size=None) -> dict:
    """`rank` / `world_size` None: this process's shard of the process group
    (`resolve_shard`); every rank returns the full-set metrics."""
    rank, world_size = resolve_shard(rank, world_size)
    loader = eval_loader(dataset, batch_size, rank=rank, world_size=world_size)
    enc = Encoders(params, cfg, batch_size=batch_size, device=device)
    feats, _, _metas = collect_encoded(loader, enc, {"image": "image", "text": "text"})
    image_feats, text_feats = merge_across_ranks(len(dataset), world_size, feats["image"], feats["text"])
    return matching_metrics(image_feats, text_feats)
