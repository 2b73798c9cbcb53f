"""The port's copy of the CLIP tokenizer (`seesaw_tpu_torch.models.tokenizer`)
gives exactly the JAX package's ids: BPE on the synthetic vocab of
tests/test_tokenizer_parity.py over its corpus and test strings, the hash
fallback, and the choice `default_tokenizer` makes."""
import sys
from pathlib import Path

import numpy as np
import pytest

from seesaw_tpu.models import tokenizer as J
from seesaw_tpu_torch.models import tokenizer as T

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_tokenizer_parity import CORPUS, TEST_STRINGS  # noqa: E402


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    from seesaw_tpu.models.bpe_train import write_artifacts

    return write_artifacts(tmp_path_factory.mktemp("clip_vocab"), CORPUS, n_merges=400)


@pytest.fixture(scope="module")
def bpe_pair(vocab_files):
    v, m = (str(p) for p in vocab_files)
    return J.BpeTokenizer(v, m, context_length=77), T.BpeTokenizer(v, m, context_length=77)


@pytest.mark.parametrize("text", TEST_STRINGS + CORPUS)
def test_bpe_ids_match_jax(bpe_pair, text):
    want, got = bpe_pair
    np.testing.assert_array_equal(got.encode(text), want.encode(text))
    assert got.tokenize(text) == want.tokenize(text)
    assert (got.sot, got.eot) == (want.sot, want.eot)


@pytest.mark.parametrize("context_length,vocab_size", [(77, 49408), (16, 99)])
def test_hash_ids_match_jax(context_length, vocab_size):
    want = J.HashTokenizer(context_length, vocab_size)
    got = T.HashTokenizer(context_length, vocab_size)
    for text in TEST_STRINGS:
        np.testing.assert_array_equal(got.encode(text), want.encode(text))


def test_default_tokenizer_choice(vocab_files, tmp_path):
    bpe = T.default_tokenizer(77, 49408, vocab_dir=vocab_files[0].parent)
    assert isinstance(bpe, T.BpeTokenizer)
    np.testing.assert_array_equal(
        bpe.encode("a photo of a dog"),
        J.default_tokenizer(77, 49408, vocab_dir=vocab_files[0].parent).encode("a photo of a dog"))
    fallback = T.default_tokenizer(16, 99, vocab_dir=tmp_path)
    assert isinstance(fallback, T.HashTokenizer)
    assert fallback.encode("a dog").shape == (16,)
