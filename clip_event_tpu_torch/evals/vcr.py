"""Zero-shot VCR: 4-choice answer or rationale selection (counterpart of
`clip_event_tpu/evals/vcr.py`). The prediction is the
argmax over the 4 choice similarities of each image
(reference `dataset_vcr.py:148-152`)."""

from __future__ import annotations

import numpy as np

from clip_event_tpu_torch.data.vcr import NUM_CHOICES, VCRDataset
from clip_event_tpu_torch.evals.common import (
    Encoders,
    collect_encoded,
    eval_loader,
    merge_across_ranks,
    resolve_shard,
)


def evaluate_vcr(params, cfg, dataset: VCRDataset, batch_size: int = 32, device="cuda",
                 rank=None, world_size=None) -> dict:
    rank, world_size = resolve_shard(rank, world_size)
    loader = eval_loader(dataset, batch_size, rank=rank, world_size=world_size)
    enc = Encoders(params, cfg, batch_size=batch_size, device=device)
    feats, kept, _ = collect_encoded(loader, enc, {"image": "image", "text": "text"}, keep=("label",))
    # per rank the text feats are [n_local·C, E]: regroup by example before
    # the weave
    local_text = feats["text"].reshape(feats["image"].shape[0], NUM_CHOICES, -1)
    image_feats, text_feats, gold = merge_across_ranks(
        len(dataset), world_size, feats["image"], local_text, kept["label"]
    )  # [N, E], [N, C, E], [N]
    logits = np.einsum("ne,nce->nc", image_feats, text_feats)
    pred = logits.argmax(axis=1)
    return {"accuracy": float((pred == gold).mean()), "num_questions": int(len(gold))}
