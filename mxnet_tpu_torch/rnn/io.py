"""Bucketed sequence iterators; the PyTorch counterpart of
``mxnet_tpu/rnn/io.py`` (reference: python/mxnet/rnn/io.py). Batches are
host NDArrays, as the port's ``NDArrayIter`` gives; a bound executor
copies them to the card."""
from __future__ import annotations

import random as pyrandom

import numpy as onp

from ..io.io import DataBatch, DataDesc, DataIter, _host

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Token sentences -> id sentences, building/extending `vocab`
    (reference io.py:encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token:
                        word = unknown_token
                    else:
                        raise ValueError(f"unknown token {word!r}")
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed, padded sentence iterator (reference
    io.py:BucketSentenceIter)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lens = onp.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
        buckets.sort()
        self.buckets = buckets
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = onp.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = onp.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # empty buckets keep a 2-D (0, bucket_len) shape so reset()'s
        # label shift slicing stays valid
        self.data = [onp.asarray(x, dtype=dtype) if x
                     else onp.empty((0, blen), dtype=dtype)
                     for x, blen in zip(self.data, buckets)]
        if ndiscard:
            import logging

            logging.warning("discarded %d sentences longer than the "
                            "largest bucket", ndiscard)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        # provide_* reflect the LARGEST bucket (reference behavior)
        shape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 \
            else (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]
        self.idx = [(i, j) for i, buck in enumerate(self.data)
                    for j in range(0, len(buck) - batch_size + 1,
                                   batch_size)]
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        pyrandom.shuffle(self.idx)
        for buck in self.data:
            onp.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = onp.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch([_host(data)], [_host(label)], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(
                             self.data_name, data.shape,
                             layout=self.layout)],
                         provide_label=[DataDesc(
                             self.label_name, label.shape,
                             layout=self.layout)])
