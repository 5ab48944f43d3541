"""Event/argument local attention over ViT grid tokens ("multiattention"):
counterpart of `clip_event_tpu/models/local_attention.py`.

  * bbox → patch-window mapping (floor/ceil, reference `utils_image.py:28-32`)
    as a broadcast comparison against the grid: one [B, R, G²] 0/1 tensor,
    no host loop, static shapes;
  * window pooling of grid tokens per box: `mean`, or `attention` (the CLS
    token's query attends over the window);
  * per-image InfoNCE between box features and role-description features,
    in the `desc` / `desc_type` / `desc_type_text` contrast modes:
    desc_type adds box↔role-type-label terms, desc_type_text adds a
    description↔label term.

CE is averaged over an image's valid boxes and summed over images. The
numerics are JAX's: products accumulate in fp32 and the pooled features are
cast back to the grid's dtype; padding columns get a -1e9 bias; a padding
box pools to zeros, and its feature is swapped for a safe vector before
`l2_normalize` and zeroed after (the "double where"), since the norm's
gradient at 0 is NaN. In "attention" mode a padding box's row is a softmax
over nothing but -inf, NaN in the forward pass; the second `where` masks
it, and the gradients stay finite (`tests/test_torch_local_attention.py`
pins it). Every op is a plain PyTorch op on static shapes, with no host
read of a device value, so the branch runs inside a captured train step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from clip_event_tpu_torch.models import clip as clip_model
from clip_event_tpu_torch.models.clip import CLIPConfig, l2_normalize

TRAIN_ARGS = ("desc", "desc_type", "desc_type_text")


def bbox_window_weights(bboxes: torch.Tensor, mask: torch.Tensor, grid: int) -> torch.Tensor:
    """Normalized boxes [B, R, 4] (xyxy) + validity mask [B, R] → 0/1
    window membership [B, R, G²] over row-major grid cells, fp32."""
    g = torch.arange(grid, dtype=torch.float32, device=bboxes.device)
    # cell (row=gy, col=gx); window: floor(min·G) ≤ idx < ceil(max·G)
    x_lo = torch.floor(bboxes[..., 0] * grid)[..., None]  # [B, R, 1]
    y_lo = torch.floor(bboxes[..., 1] * grid)[..., None]
    x_hi = torch.ceil(bboxes[..., 2] * grid)[..., None]
    y_hi = torch.ceil(bboxes[..., 3] * grid)[..., None]
    in_x = (g >= x_lo) & (g < x_hi)  # [B, R, G]
    in_y = (g >= y_lo) & (g < y_hi)
    window = in_y[..., :, None] & in_x[..., None, :]  # [B, R, G(y), G(x)]
    window = window.reshape(window.shape[0], window.shape[1], grid * grid)
    return window.float() * mask[..., None].float()


def pool_bbox_features(
    grid_feats: torch.Tensor,  # [B, G², D] (ViT tokens without CLS)
    bboxes: torch.Tensor,  # [B, R, 4]
    mask: torch.Tensor,  # [B, R]
    grid: int,
    mode: str = "mean",
    cls_feats: Optional[torch.Tensor] = None,  # [B, D] for attention mode
) -> torch.Tensor:
    """[B, R, D] pooled box features in grid_feats' dtype."""
    weights = bbox_window_weights(bboxes, mask, grid)  # [B, R, G²]
    if mode == "mean":
        counts = weights.sum(-1, keepdim=True).clamp_min(1.0)
        return torch.einsum("brg,bgd->brd", weights / counts, grid_feats.float()).to(grid_feats.dtype)
    if mode == "attention":
        if cls_feats is None:
            raise ValueError("attention pooling needs the CLS query")
        d = grid_feats.shape[-1]
        logits = torch.einsum(
            "bd,bgd->bg", (cls_feats * d**-0.5).float(), grid_feats.float()
        )[:, None, :]  # [B, 1, G²]: the query's scores, shared by every box
        inside = weights > 0
        logits = torch.where(inside, logits, float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        attn = torch.where(inside, attn, 0.0)  # empty windows → all zeros
        return torch.einsum("brg,bgd->brd", attn, grid_feats.float()).to(grid_feats.dtype)
    raise ValueError(f"unknown pooling mode {mode!r}")


def _masked_infonce(
    a: torch.Tensor,  # [B, R, E] normalized
    b: torch.Tensor,  # [B, R, E] normalized
    mask: torch.Tensor,  # [B, R]
    scale: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image diagonal-label CE in both directions, the mean over valid
    rows, summed over images. Returns (loss_a→b, loss_b→a)."""
    logits = scale * torch.einsum("bre,bse->brs", a.float(), b.float())
    valid = mask.float()
    logits = logits + (mask[:, None, :] <= 0).float() * -1e9  # padding columns

    def ce(lg):
        logp = torch.log_softmax(lg, dim=-1)
        diag = torch.diagonal(logp, dim1=1, dim2=2)  # [B, R]
        per_image = -(diag * valid).sum(-1) / valid.sum(-1).clamp_min(1.0)
        has_rows = (valid.sum(-1) > 0).float()
        return (per_image * has_rows).sum()

    return ce(logits), ce(logits.transpose(1, 2))


def local_attention_loss(
    params: dict,
    cfg: CLIPConfig,
    images: torch.Tensor,  # [B, H, W, 3]
    bboxes: torch.Tensor,  # [B, R, 4] normalized xyxy
    bbox_mask: torch.Tensor,  # [B, R]
    desc_tokens: Optional[torch.Tensor] = None,  # [B, R, S] role descriptions
    label_tokens: Optional[torch.Tensor] = None,  # [B, R, S] role-type labels
    train_arg: str = "desc",
    pooling: str = "mean",
    compute_dtype=torch.float32,
    impl: Optional[str] = None,
    remat=False,
    # dedupe-encode channel (data/dedupe.py): unique token rows [U, S] and
    # the inverse index [B·R]; exact for loss and gradients
    desc_unique: Optional[torch.Tensor] = None,
    desc_inverse: Optional[torch.Tensor] = None,
    label_unique: Optional[torch.Tensor] = None,
    label_inverse: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """{'loss_bbox', 'loss_arg'} (reference `loss_per_bbox`,
    `loss_per_arg`). The image is encoded with `use_grid=True`: a second
    encode beside the contrastive term's, as in JAX."""
    if train_arg not in TRAIN_ARGS:
        raise ValueError(f"train_arg must be one of {TRAIN_ARGS}")
    if not cfg.is_vit:
        raise ValueError("local attention requires the ViT tower's grid tokens")
    if desc_tokens is None and desc_unique is None:
        raise ValueError("need desc_tokens or desc_unique+desc_inverse")

    B, R = bbox_mask.shape[:2]
    kw = dict(compute_dtype=compute_dtype, impl=impl, remat=remat)
    tokens = clip_model.encode_image(params, cfg, images, use_grid=True, **kw)  # [B, G²+1, E]
    cls_feats, grid_feats = tokens[:, 0], tokens[:, 1:]

    bbox_feats = pool_bbox_features(
        grid_feats, bboxes, bbox_mask, cfg.grid_size, mode=pooling, cls_feats=cls_feats
    )
    # the double where: a padding box's zeros would give NaN gradients
    # through the norm
    m = bbox_mask[..., None] > 0
    safe = torch.where(m, bbox_feats, torch.ones_like(bbox_feats))
    bbox_feats = torch.where(m, l2_normalize(safe), torch.zeros_like(bbox_feats))

    def encode_role_texts(tokens, unique, inverse):
        """[B, R, S] (or deduped [U, S] + [B·R]) → normalized [B, R, E]."""
        if unique is not None:
            feats = l2_normalize(clip_model.encode_text(params, cfg, unique, **kw))[inverse.long()]
        else:
            feats = l2_normalize(clip_model.encode_text(params, cfg, tokens.reshape(B * R, -1), **kw))
        return feats.reshape(B, R, -1)

    desc_feats = encode_role_texts(desc_tokens, desc_unique, desc_inverse)

    scale = params["logit_scale"].exp().float()
    loss_bbox, loss_arg = _masked_infonce(bbox_feats, desc_feats, bbox_mask, scale)

    if train_arg.startswith("desc_type"):
        if label_tokens is None and label_unique is None:
            raise ValueError("desc_type modes need label tokens")
        label_feats = encode_role_texts(label_tokens, label_unique, label_inverse)
        lb, la = _masked_infonce(bbox_feats, label_feats, bbox_mask, scale)
        loss_bbox = loss_bbox + lb
        loss_arg = loss_arg + la
        if train_arg.startswith("desc_type_text"):
            dl, _ = _masked_infonce(desc_feats, label_feats, bbox_mask, scale)
            loss_arg = loss_arg + dl

    return {"loss_bbox": loss_bbox, "loss_arg": loss_arg}
