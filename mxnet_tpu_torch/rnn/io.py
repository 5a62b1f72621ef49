"""Bucketed sentences (the counterpart of `mxnet_tpu/rnn/io.py`; reference
`python/mxnet/rnn/io.py`): `encode_sentences` maps tokens to ids and
`BucketSentenceIter` pads each sentence to the smallest bucket that holds
it and yields one bucket's batch at a time, for `BucketingModule`.

As in the reference, `BucketSentenceIter.reset` shuffles without a seed:
the order of the batches from Python's `random`, the sentences within
each bucket from a fresh `numpy.random.default_rng()`.  Batches are CPU
NDArrays; the module copies each into its bound inputs.
"""
from __future__ import annotations

import bisect
import logging
import random as _pyrandom

import numpy as np
import torch

from ..base import MXNetError
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import NDArray

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Token lists as id lists, growing ``vocab`` where it is new
    (reference `io.py:encode_sentences`): ``(encoded, vocab)``.  With a
    given ``vocab``, an unknown word maps to ``unknown_token`` or
    raises."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
        idx = max(max(vocab.values()) + 1, idx)
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token is None:
                        raise MXNetError(f"unknown token {word!r}")
                    word = unknown_token
                    if word not in vocab:
                        vocab[word] = idx
                        idx += 1
                else:
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


def _host(a: np.ndarray) -> NDArray:
    return NDArray(torch.from_numpy(np.ascontiguousarray(a)))


class BucketSentenceIter(DataIter):
    """Per-bucket batches of padded sentences, the label the data shifted
    left by one (reference `io.py:BucketSentenceIter`).  ``provide_data``
    and ``provide_label`` describe the default (largest) bucket; each
    batch carries its ``bucket_key`` and its own descriptors.  Sentences
    longer than the largest bucket are dropped; a bucket's last partial
    batch is not served."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if layout != "NT":
            raise MXNetError("only NT layout is supported")
        if not buckets:
            lengths = [len(s) for s in sentences]
            cnt = np.bincount([n for n in lengths if n > 0])
            buckets = [i for i, n in enumerate(cnt)
                       if n >= max(1, batch_size // 8)] or [max(lengths)]
        buckets = sorted(set(buckets))
        data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buf = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buf[:len(sent)] = sent
            data[buck].append(buf)
        self.data = [np.asarray(x, dtype=dtype) if x else
                     np.zeros((0, b), dtype=dtype)
                     for x, b in zip(data, buckets)]
        if ndiscard:
            logging.getLogger(__name__).warning(
                "discarded %d sentences longer than the largest bucket",
                ndiscard)
        self.buckets = buckets
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.default_bucket_key = max(buckets)
        self.provide_data = [DataDesc(
            data_name, (batch_size, self.default_bucket_key))]
        self.provide_label = [DataDesc(
            label_name, (batch_size, self.default_bucket_key))]
        self.idx = [(i, j) for i, buck in enumerate(self.data)
                    for j in range(0, len(buck) - batch_size + 1,
                                   batch_size)]
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            np.random.default_rng(None).shuffle(buck, axis=0)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.data[i][j:j + self.batch_size]
        label = np.full_like(data, self.invalid_label)
        label[:, :-1] = data[:, 1:]
        return DataBatch(
            data=[_host(data)], label=[_host(label)],
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape)],
            provide_label=[DataDesc(self.label_name, label.shape)])
