"""Image↔text retrieval on COCO / Flickr30k (counterpart of
`clip_event_tpu/evals/retrieval.py`), single device. C captions per image;
text→image: the rank of the paired image; image→text: the best rank of its
C captions. Reports R@1/5/10 both ways."""

from __future__ import annotations

import numpy as np

from clip_event_tpu_torch.evals.common import Encoders, collect_encoded, eval_loader, recall_at_k


def evaluate_retrieval(params, cfg, dataset, batch_size: int = 32, device="cuda") -> dict:
    C = dataset.captions_per_image
    loader = eval_loader(dataset, batch_size)
    enc = Encoders(params, cfg, batch_size=batch_size, device=device)
    feats, _, _ = collect_encoded(loader, enc, {"image": "image", "text": "text"})
    image_feats = feats["image"]
    N = image_feats.shape[0]
    text_feats = feats["text"].reshape(N * C, -1)
    sims = text_feats @ image_feats.T  # [N·C, N]

    # text → image
    t2i_order = np.argsort(-sims, axis=1)
    gold_image = np.repeat(np.arange(N), C)
    t2i_ranks = np.argmax(t2i_order == gold_image[:, None], axis=1)

    # image → text: the best rank among the C paired captions, through the
    # inverse permutation (each caption's rank position)
    i2t_order = np.argsort(-sims.T, axis=1)  # [N, N·C]
    positions = np.empty_like(i2t_order)
    np.put_along_axis(positions, i2t_order, np.broadcast_to(np.arange(N * C), (N, N * C)), axis=1)
    i2t_ranks = positions.reshape(N, N, C)[np.arange(N), np.arange(N)].min(axis=1)

    out = {f"t2i_{k}": v for k, v in recall_at_k(t2i_ranks).items()}
    out.update({f"i2t_{k}": v for k, v in recall_at_k(i2t_ranks).items()})
    out["num_images"] = int(N)
    return out
