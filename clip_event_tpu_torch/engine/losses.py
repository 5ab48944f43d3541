"""Contrastive criteria (counterpart of `clip_event_tpu/engine/losses.py`;
reference `CriterionContrastive`, `model_clip.py:620-662`).

Text-side loss is always cross-entropy over the batch, restricted to the
positive-description rows via the `index_pos` gather. Image-side loss is
CE / BCE / KL per config. Every loss is computed in fp32; reductions match
torch defaults (CE: mean over rows; BCEWithLogits: mean over elements). KL
is KL(target ‖ softmax(logits)) with row-normalized soft targets, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

LOSS_TYPES = ("ce", "bce", "kl")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels (torch `nn.CrossEntropyLoss` semantics)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, 1, labels.long()[:, None])
    return -picked.mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean-over-elements binary CE (torch `nn.BCEWithLogitsLoss`)."""
    x = logits.float()
    t = targets.float()
    # numerically stable: max(x,0) - x*t + log(1+exp(-|x|))
    return (torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def kl_divergence(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """KL(target ‖ softmax(logits)), batch-mean. Targets are soft labels."""
    t = targets.float()
    t = t / torch.clamp(t.sum(dim=-1, keepdim=True), min=1e-8)
    logp = torch.log_softmax(logits.float(), dim=-1)
    terms = t * (torch.log(torch.clamp(t, min=1e-20)) - logp)
    return torch.where(t > 0, terms, torch.zeros_like(terms)).sum(-1).mean()


def contrastive_loss(
    logits_per_image: torch.Tensor,
    logits_per_text: torch.Tensor,
    labels_per_image: torch.Tensor,
    labels_per_text: torch.Tensor,
    index_pos: torch.Tensor,
    loss_type: str = "ce",
) -> Dict[str, torch.Tensor]:
    """Returns {'loss_i', 'loss_t'} like the reference criterion.

    index_pos: int tensor of positive-description row indices into the
    flattened text batch (`index_description_pos`, `dataset_voa.py:659-663`).
    """
    if loss_type == "ce":
        loss_i = cross_entropy(logits_per_image, labels_per_image)
    elif loss_type == "bce":
        loss_i = bce_with_logits(logits_per_image, labels_per_image)
    elif loss_type == "kl":
        loss_i = kl_divergence(logits_per_image, labels_per_image)
    else:
        raise ValueError(f"invalid contrastive loss {loss_type!r}")

    index_pos = index_pos.long()
    pos_logits = logits_per_text.index_select(0, index_pos)
    pos_labels = labels_per_text.index_select(0, index_pos)
    loss_t = cross_entropy(pos_logits, pos_labels)
    return {"loss_i": loss_i, "loss_t": loss_t}
