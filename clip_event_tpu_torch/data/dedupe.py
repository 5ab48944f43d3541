"""Batch-level text deduplication (exact, gather-based; own copy of
`clip_event_tpu/data/dedupe.py`, numpy only).

The contrastive text batch flattens pos∥neg_event∥neg_argument descriptions
(reference `dataset_voa.py:607-612`) and the local-attention branch encodes
one role description + one role-type label per bbox (reference
`model_clip.py:423-488`) — on template corpora and label vocabularies these
rows repeat heavily (the role-type labels of a B=256·R=8 batch draw from a
few dozen strings), so the text tower re-encodes identical token rows many
times per step.

This module computes, on the host, each batch's UNIQUE token rows padded to
a static cap plus the inverse index that reconstructs the full layout. The
device step then encodes only the unique rows and gathers features back:

    feats = encode_text(unique)[inverse]        # [N, E], bitwise the full
                                                # batch's features

which is EXACT for the loss (the gathered features are the same values) and
for the parameter gradients (a gather's VJP scatter-adds the duplicate rows'
cotangents — the same sum the undeduped backward accumulates inside its
matmuls, up to float reduction order). Encode cost becomes ∝ the unique
count instead of the batch size. Equality is tested in
`tests/test_dedupe.py`; measured throughput in PERFORMANCE.md.

Static shapes: the unique array is padded to `cap` rows (zero rows encode to
garbage features that nothing indexes — their gradient contribution is
exactly zero because no inverse entry points at them). A batch whose unique
count exceeds the cap cannot be represented; the fallback emits the identity
layout (unique = the full batch, inverse = arange), which is a DIFFERENT
static shape — one extra jit specialization. Under multi-host assembly or
stacked-batch dispatch the shapes must agree across ranks/stack entries, so
there `strict=True` turns overflow into an error instead (raise the cap).

Multi-host: each process dedupes its LOCAL rows into its own cap//world
block of the global unique array (`jax.make_array_from_process_local_data`
concatenates rank blocks), and offsets its inverse indices by rank·cap//world
— no cross-host coordination, at the cost of not deduping across ranks.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


_overflow_warned: set = set()


class DedupeOverflow(ValueError):
    """Unique row count exceeded the static cap in strict mode."""


def dedupe_rows(
    rows: np.ndarray,
    cap: int,
    rank: int = 0,
    world: int = 1,
    strict: bool = False,
    tag: str = "text",
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """[N, S] token rows → (unique [cap//world, S], inverse [N] int32).

    `unique[inverse - rank*cap//world] == rows` row-for-row; pad slots are
    zero. Returns None on overflow when not strict (caller falls back to the
    identity layout); raises DedupeOverflow when strict.
    """
    if cap % world:
        raise ValueError(f"dedupe cap {cap} must divide by world size {world}")
    cap_local = cap // world
    unique, inverse = np.unique(rows, axis=0, return_inverse=True)
    if len(unique) > cap_local:
        msg = (
            f"dedupe[{tag}]: batch has {len(unique)} unique rows > local cap "
            f"{cap_local} (global cap {cap} / world {world}) — raise the cap"
        )
        if strict:
            raise DedupeOverflow(msg)
        if tag not in _overflow_warned:  # once per channel, not per batch
            _overflow_warned.add(tag)
            log.warning(
                "%s; falling back to the undeduped layout for this batch "
                "(further overflows on this channel fall back silently)", msg
            )
        return None
    padded = np.zeros((cap_local,) + rows.shape[1:], dtype=rows.dtype)
    padded[: len(unique)] = unique
    return padded, (inverse.astype(np.int32) + rank * cap_local)


def identity_layout(rows: np.ndarray, rank: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The no-dedupe fallback in the same (unique, inverse) contract.

    Only valid single-host (rank 0): under multi-host assembly the global
    unique array is rank blocks of cap//world rows each, which an
    arbitrary-length identity block would misalign.
    """
    assert rank == 0, "identity fallback is single-host only (strict mode covers multi-host)"
    return rows, np.arange(len(rows), dtype=np.int32)
