"""Static label layouts for the hard-negative contrastive batch (own copy of
`clip_event_tpu/data/labels.py`, numpy only).

Reimplements the label-vector construction of the reference collate
(`dataset_voa.py:614-663`) as pure shape arithmetic: given (batch_size B,
num_pos P, num_neg G, loss type, over-batch flag), emit

  labels_per_image:
    ce  + overbatch : [B]    int   — arange(B)·D (pos row in flattened text)
    ce  + instance  : [B]    int   — zeros (pos is first text of instance)
    bce + instance  : [B, D] float — 1 at the first P slots
    kl  + overbatch : [B, B·D] float — uniform mass on own positives
  labels_per_text  : [B·D] int — image index repeated D times
  index_pos        : [B·P] int — rows of positive descriptions

where D = P + G. Everything is static given the config, so the arrays are
built once per dataset, not per step.

Multi-host (`world_size > 1`): the over-batch InfoNCE is GLOBAL — GSPMD
all-gathers the batch-sharded features, so label values must index the
GLOBAL text/image rows while each process supplies only ITS block of label
ROWS (the per-rank slice of the global batch the loader assembles via
`jax.make_array_from_process_local_data`, `parallel/mesh.py::shard_batch`).
`rank`/`world_size` therefore build the layout at the global batch size
`B·world_size` and return rank `rank`'s row block — except `index_pos`,
which stays the full global table (it is replicated, not batch-sharded).
The reference never faced this: its per-GPU loss is local, only gradients
cross ranks (DDP, `train.py:222-225`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LabelLayout(NamedTuple):
    labels_per_image: np.ndarray
    labels_per_text: np.ndarray
    index_pos: np.ndarray


def build_label_layout(
    batch_size: int,
    num_pos: int,
    num_neg: int,
    loss_type: str = "ce",
    overbatch: bool = True,
    rank: int = 0,
    world_size: int = 1,
) -> LabelLayout:
    D = num_pos + num_neg
    B = batch_size  # per-process rows
    Bg = B * world_size  # global batch the in-batch contrast runs over
    rows = slice(rank * B, (rank + 1) * B)

    if loss_type == "ce":
        if num_pos != 1:
            raise ValueError("loss_type='ce' requires exactly one positive per image")
        if overbatch:
            labels_per_image = (np.arange(Bg) * D).astype(np.int32)[rows]
        else:
            labels_per_image = np.zeros(B, np.int32)
    elif loss_type == "bce":
        if overbatch:
            raise ValueError("set overbatch=False for loss_type='bce'")
        # per-instance logits: no cross-batch (or cross-rank) columns
        labels_per_image = np.tile(
            np.concatenate([np.ones(num_pos), np.zeros(num_neg)]).astype(np.float32),
            (B, 1),
        )
    elif loss_type == "kl":
        if not overbatch:
            raise ValueError("set overbatch=True for loss_type='kl'")
        labels_per_image = np.zeros((B, Bg * D), np.float32)
        for b in range(B):
            g = rank * B + b
            labels_per_image[b, g * D : g * D + num_pos] = 1.0
    else:
        raise ValueError(f"invalid contrastive loss {loss_type!r}")

    labels_per_text = np.repeat(np.arange(Bg), D).astype(np.int32)[
        rank * B * D : (rank + 1) * B * D
    ]
    mask = np.tile(
        np.concatenate([np.ones(num_pos, bool), np.zeros(num_neg, bool)]), Bg
    )
    index_pos = np.nonzero(mask)[0].astype(np.int32)
    return LabelLayout(labels_per_image, labels_per_text, index_pos)
