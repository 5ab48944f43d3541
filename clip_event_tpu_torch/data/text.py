"""Tokenize-only dataset (reference `dataset_text.py`): strings → [N, 77]."""

from __future__ import annotations

from typing import Sequence

from clip_event_tpu_torch.data.common import ExampleDataset
from clip_event_tpu_torch.tokenizer import tokenize


class TextDataset(ExampleDataset):
    def __init__(self, texts: Sequence[str], context: int = 0):
        """`context`: tokenize to this static width instead of 77 — exact for
        texts whose EOT fits (causal + EOT pooling), truncate-keep-EOT
        beyond; the embed CLI's length_buckets groups texts so every one
        fits its bucket's width."""
        self.texts = list(texts)
        self.context = int(context) or None

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, idx: int):
        tok = (
            tokenize(self.texts[idx], self.context)
            if self.context
            else tokenize(self.texts[idx])
        )
        return {"text": tok[0]}, {"text": self.texts[idx]}
