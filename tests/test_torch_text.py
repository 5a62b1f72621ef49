"""The port's `contrib.text` against the JAX package's, on the CPU.

* The JAX package's own `tests/test_contrib_text_cases.py` runs on the
  port (`torch_ps_parity.port_tests`), each test under ``with cpu():``.
* `Vocabulary`, `CustomEmbedding` (with and without a vocabulary, updated
  vectors included), `CompositeEmbedding` and `GloVe` read from a file
  placed under ``MXNET_HOME`` give the same tokens, indices and vectors
  (bit-equal) in both packages; ``idx_to_vec`` lives on the context the
  embedding was made in.
"""
import collections

import numpy as np
import pytest

import mxnet_tpu as jx
import mxnet_tpu_torch as tx
import torch_ps_parity as parity

globals().update(parity.port_tests("test_contrib_text_cases.py"))

CORPUS = ("the cat sat on the mat\nthe dog sat on the log\n"
          "a cat and a dog\n")


def _write(path, n, dim, seed):
    rng = np.random.RandomState(seed)
    words = ["the", "cat", "sat", "on", "mat", "dog", "log", "a", "and"]
    with open(path, "w") as f:
        for i in range(n):
            tok = words[i] if i < len(words) else f"w{i}"
            vals = " ".join(f"{v:.6f}" for v in rng.randn(dim))
            f.write(f"{tok} {vals}\n")


def _same(t, j):
    assert t.idx_to_token == j.idx_to_token
    assert t.token_to_idx == j.token_to_idx
    np.testing.assert_array_equal(t.idx_to_vec.asnumpy(),
                                  j.idx_to_vec.asnumpy())


def _both(fn):
    j = fn(jx)
    with tx.cpu():
        t = fn(tx)
    return t, j


def test_vocabulary_matches_reference():
    def make(pkg):
        text = pkg.contrib.text
        c = text.count_tokens_from_str(CORPUS)
        return [text.Vocabulary(c, **kw) for kw in (
            {}, {"min_freq": 2}, {"most_freq_count": 3},
            {"reserved_tokens": ["<pad>", "<bos>"]})]
    t, j = _both(make)
    for a, b in zip(t, j):
        assert a.idx_to_token == b.idx_to_token
        assert a.token_to_idx == b.token_to_idx
        assert a.to_indices(["cat", "zzz", "the"]) == \
            b.to_indices(["cat", "zzz", "the"])


def test_custom_and_composite_embeddings_match_reference(tmp_path):
    p1, p2 = tmp_path / "a.txt", tmp_path / "b.txt"
    _write(p1, 40, 5, 0)
    _write(p2, 30, 3, 1)

    def make(pkg):
        text = pkg.contrib.text
        e1 = text.CustomEmbedding(str(p1))
        e2 = text.CustomEmbedding(str(p2))
        vocab = text.Vocabulary(text.count_tokens_from_str(CORPUS))
        e3 = text.CustomEmbedding(str(p1), vocabulary=vocab)
        e1.update_token_vectors(["cat", "dog"],
                                pkg.nd.array(np.full((2, 5), 7.5,
                                                     np.float32)))
        comp = text.CompositeEmbedding(vocab, [e1, e2])
        got = e1.get_vecs_by_tokens(["dog", "nope", "w20"]).asnumpy()
        return [e1, e2, e3, comp], got
    (t, tgot), (j, jgot) = _both(make)
    for a, b in zip(t, j):
        _same(a, b)
    np.testing.assert_array_equal(tgot, jgot)
    assert t[3].idx_to_vec.context == tx.cpu()


def test_glove_from_a_placed_file_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    root = tmp_path / "embeddings" / "glove"
    root.mkdir(parents=True)
    _write(root / "glove.6B.50d.txt", 25, 50, 2)
    t, j = _both(lambda pkg: pkg.contrib.text.create(
        "glove", pretrained_file_name="glove.6B.50d.txt"))
    _same(t, j)
    with tx.cpu(), pytest.raises(tx.MXNetError,
                                 match="glove.6B.zip"):
        tx.contrib.text.GloVe("glove.6B.100d.txt")
    assert tx.contrib.text.list_embedding_names() == \
        jx.contrib.text.list_embedding_names()
    assert tx.contrib.text.FastText.get_pretrained_file_names() == \
        jx.contrib.text.FastText.get_pretrained_file_names()


def test_count_tokens_matches_reference():
    for kw in ({}, {"to_lower": True}, {"token_delim": "a"}):
        c0 = collections.Counter({"the": 3})
        c1 = collections.Counter({"the": 3})
        assert tx.contrib.text.count_tokens_from_str(
            CORPUS, counter_to_update=c0, **kw) == \
            jx.contrib.text.count_tokens_from_str(
                CORPUS, counter_to_update=c1, **kw)
