"""Zero-shot VisualCOMET inference ranking (counterpart of
`clip_event_tpu/evals/visualcomet.py`), single device. Each image ranks the
pool of inference texts; its gold rank is the best-ranked of its gold
inferences. Reports R@1/5/10 and the mean rank."""

from __future__ import annotations

import numpy as np

from clip_event_tpu_torch.data.visualcomet import VisualCOMETDataset
from clip_event_tpu_torch.evals.common import Encoders, collect_encoded, eval_loader, recall_at_k


def evaluate_visualcomet(params, cfg, dataset: VisualCOMETDataset, batch_size: int = 32,
                         device="cuda") -> dict:
    loader = eval_loader(dataset, batch_size)
    enc = Encoders(params, cfg, batch_size=batch_size, device=device)
    feats, _, metas = collect_encoded(loader, enc, {"image": "image"})
    cand_feats = enc.texts(dataset.candidate_tokens)
    logits = feats["image"] @ cand_feats.T  # [N, C]
    order = np.argsort(-logits, axis=1)

    # each candidate's rank position (the inverse of the row's argsort),
    # then the min over the row's gold ids
    n, c = order.shape
    positions = np.empty_like(order)
    np.put_along_axis(positions, order, np.broadcast_to(np.arange(c), (n, c)), axis=1)
    ranks = np.asarray([positions[i, list(meta["gold_ids"])].min() for i, meta in enumerate(metas)])
    out = recall_at_k(ranks)
    out["mean_rank"] = float(ranks.mean() + 1)
    out["num_images"] = int(len(ranks))
    out["num_candidates"] = int(len(dataset.candidates))
    return out
