"""Byte-level BPE tokenizer for CLIP (49,408-entry vocab).

Host-side reimplementation of the CLIP tokenizer with the exact semantics of
the reference (CLIP's `simple_tokenizer.py` and `clip.py:168-201`):
byte→unicode remapping, lowercased BPE over the 16e6-merge vocab, SOT/EOT
framing, and truncate-to-context-keeping-EOT.

Output is a fixed-shape int32 array `[N, context_length]`, zero padded. Own
copy of `clip_event_tpu/tokenizer.py`, reading its own copy of the vocab
(`assets/`), byte for byte the same.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Sequence, Union

import numpy as np
import regex as _regex

try:  # optional: mojibake fixing, matches reference behaviour when present
    import ftfy as _ftfy
except ImportError:  # pragma: no cover - environment without ftfy
    _ftfy = None

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
_N_MERGES = VOCAB_SIZE - 256 * 2 - 2  # 48894 merge rules

_WORD_PATTERN = _regex.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    _regex.IGNORECASE,
)
_WHITESPACE = _regex.compile(r"\s+")
# The matches keep the GIL (`concurrent=False`): the loader tokenizes on
# many threads, and a match that releases and retakes the GIL on every call
# makes them queue for it (16 threads ran slower than one).


def default_vocab_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "assets",
        "bpe_simple_vocab_16e6.txt.gz",
    )


@functools.lru_cache()
def byte_to_unicode_table() -> dict:
    """Invertible byte→printable-unicode map used by GPT-2-style BPE.

    Printable latin bytes map to themselves; the remaining bytes are pushed
    into the 256+ codepoint range so no token string ever contains raw
    whitespace/control characters.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


def _clean_text(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _WHITESPACE.sub(" ", text, concurrent=False)
    return text.strip()


class ClipTokenizer:
    """Stateful BPE codec. One instance per process; `encode` is pure."""

    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or default_vocab_path()
        self._b2u = byte_to_unicode_table()
        self._u2b = {u: b for b, u in self._b2u.items()}

        with gzip.open(vocab_path, "rt", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        merge_rules = [tuple(line.split()) for line in lines[1 : _N_MERGES + 1]]

        tokens: List[str] = list(self._b2u.values())
        tokens += [t + "</w>" for t in tokens]
        tokens += ["".join(rule) for rule in merge_rules]
        tokens += ["<|startoftext|>", "<|endoftext|>"]
        self.token_to_id = {tok: i for i, tok in enumerate(tokens)}
        self.id_to_token = {i: tok for tok, i in self.token_to_id.items()}
        self.merge_rank = {rule: i for i, rule in enumerate(merge_rules)}
        self.sot_id = self.token_to_id["<|startoftext|>"]
        self.eot_id = self.token_to_id["<|endoftext|>"]
        self._bpe_cache: dict = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def __len__(self) -> int:
        return len(self.token_to_id)

    # ---------------------------------------------------------------- BPE

    def _apply_bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        if len(token) == 0:
            return token
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]

        while len(parts) > 1:
            # lowest-rank adjacent pair wins
            best_rank = None
            best_pair = None
            for pair in zip(parts[:-1], parts[1:]):
                rank = self.merge_rank.get(pair)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_pair = pair
            if best_pair is None:
                break
            first, second = best_pair
            merged: List[str] = []
            i = 0
            n = len(parts)
            while i < n:
                if i < n - 1 and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        out = " ".join(parts)
        self._bpe_cache[token] = out
        return out

    # ------------------------------------------------------------- encode

    def encode(self, text: str) -> List[int]:
        """Text → list of BPE ids (no SOT/EOT framing)."""
        ids: List[int] = []
        text = _clean_text(text).lower()
        for word in _WORD_PATTERN.findall(text, concurrent=False):
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(
                self.token_to_id[piece] for piece in self._apply_bpe(mapped).split(" ")
            )
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.id_to_token[i] for i in ids)
        raw = bytearray(self._u2b[ch] for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def get_tokenizer(vocab_path: str | None = None) -> ClipTokenizer:
    return ClipTokenizer(vocab_path)


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    tokenizer: ClipTokenizer | None = None,
) -> np.ndarray:
    """Batch-tokenize into a fixed `[N, context_length]` int32 array.

    Over-long inputs keep their first `context_length` tokens with EOT forced
    at the final slot (reference `clip.py:194-196`). Padding is 0.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or get_tokenizer()

    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tok.sot_id] + tok.encode(text) + [tok.eot_id]
        if len(ids) > context_length:
            ids = ids[:context_length]
            ids[-1] = tok.eot_id
        out[row, : len(ids)] = ids
    return out
