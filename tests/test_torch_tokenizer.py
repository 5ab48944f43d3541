"""The port's tokenizer against the JAX package's: equal ids on unicode,
long and truncated texts at several widths, and a byte-identical vocab."""

import filecmp

import numpy as np
import pytest

from clip_event_tpu import tokenizer as JT
from clip_event_tpu_torch import tokenizer as TT
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

TEXTS = [
    "a photo of a dog",
    "A PHOTO OF A CAT!!",
    "Protesters march in city 3, file photo 0.",
    "FILE - Soldiers stand guard at a checkpoint near the border.",
    "",
    "   leading and trailing   whitespace\t\n",
    "numbers 12345 and 3.14159",
    "it's they're we've I'm you'll he'd",
    "café naïve résumé façade",
    "Ünïcödé ßtraße Øresund",
    "東京の抗議デモ",
    "протест в Москве",
    "مظاهرة في القاهرة",
    "emoji 😀🎉 in text",
    "html &amp; entities &lt;b&gt;",
    "hyphenated-words and under_scores",
    "<|startoftext|> special <|endoftext|>",
    "word " * 100,
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    "A wedding ceremony in city 5. Police march against protesters in city 5.",
]


@pytest.mark.parametrize("width", [77, 16, 5])
def test_tokenize_matches_jax(width):
    ours = TT.tokenize(TEXTS, context_length=width)
    ref = JT.tokenize(TEXTS, context_length=width)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


def test_truncation_keeps_eot():
    out = TT.tokenize(["word " * 100])
    assert out[0, -1] == TT.get_tokenizer().eot_id
    assert (out[0] != 0).all()


def test_encode_decode_match_jax():
    ours, ref = TT.get_tokenizer(), JT.get_tokenizer()
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == ref.encode(text)
        assert ours.decode(ids) == ref.decode(ids)


def test_vocab_asset_is_byte_identical():
    assert filecmp.cmp(TT.default_vocab_path(), JT.default_vocab_path(), shallow=False)
    assert TT.default_vocab_path() != JT.default_vocab_path()
