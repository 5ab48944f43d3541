"""Zero-shot VCR: 4-choice answer or rationale selection (counterpart of
`clip_event_tpu/evals/vcr.py`), single device. The prediction is the
argmax over the 4 choice similarities of each image
(reference `dataset_vcr.py:148-152`)."""

from __future__ import annotations

import numpy as np

from clip_event_tpu_torch.data.vcr import NUM_CHOICES, VCRDataset
from clip_event_tpu_torch.evals.common import Encoders, collect_encoded, eval_loader


def evaluate_vcr(params, cfg, dataset: VCRDataset, batch_size: int = 32, device="cuda") -> dict:
    loader = eval_loader(dataset, batch_size)
    enc = Encoders(params, cfg, batch_size=batch_size, device=device)
    feats, kept, _ = collect_encoded(loader, enc, {"image": "image", "text": "text"}, keep=("label",))
    image_feats = feats["image"]  # [N, E]
    text_feats = feats["text"].reshape(image_feats.shape[0], NUM_CHOICES, -1)  # [N, C, E]
    logits = np.einsum("ne,nce->nc", image_feats, text_feats)
    pred = logits.argmax(axis=1)
    gold = kept["label"]
    return {"accuracy": float((pred == gold).mean()), "num_questions": int(len(gold))}
