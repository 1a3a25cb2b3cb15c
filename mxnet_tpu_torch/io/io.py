"""The DataIter protocol, NDArrayIter and friends.

The PyTorch counterpart of ``mxnet_tpu/io/io.py`` (reference:
python/mxnet/io/io.py :180-790; src/io/iter_mnist.cc, iter_csv.cc).
Batches are host (CPU) NDArrays, as in MXNet; ``DevicePrefetchIter``
(over ``pipeline.DeviceFeed``) stages them onto the card.
``PrefetchingIter`` fetches each sub-iterator's next batch on a
background thread while the current one is consumed (the JAX package
pushes that fetch to its engine's IO lane; the port has no engine yet,
slice 10).

``NDArrayIter``'s ``last_batch_handle`` follows the reference: ``"pad"``
fills the last batch from the start of the data (``pad`` says how
many), ``"discard"`` drops a short last batch, and ``"roll_over"``
carries it into the next pass, where it leads the first batch. (The
JAX package returns the short batch under both ``"discard"`` and
``"roll_over"``; its ``"pad"`` batches equal these.)
"""
from __future__ import annotations

from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as onp

from ..ndarray import NDArray
from ..ndarray.ndarray import host_tensor
from ..pipeline.device_feed import DeviceFeed as _DeviceFeedBase

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "MNISTIter", "CSVIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Reference: io.py DataDesc (name, shape, dtype, layout)."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """Reference: io.py DataBatch."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Reference: io.py DataIter."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """``data`` as a list of (name, numpy array) (reference: io.py
    _init_data)."""
    if data is None:
        if not allow_empty:
            raise ValueError(f"{default_name} must be set")
        return []
    if isinstance(data, (onp.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError(f"{default_name} cannot be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    return [(k, v.asnumpy() if isinstance(v, NDArray) else onp.asarray(v))
            for k, v in data.items()]


def _host(arr):
    return NDArray(host_tensor(onp.ascontiguousarray(arr)))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.py NDArrayIter:180);
    ``shuffle`` permutes with numpy's global generator at each
    ``reset``, as the JAX package does."""

    _MODES = ("pad", "discard", "roll_over")

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in self._MODES:
            raise ValueError(f"last_batch_handle must be one of "
                             f"{self._MODES}, got {last_batch_handle!r}")
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = onp.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        self.cursor = -batch_size
        self._cache = None  # roll_over: the short batch, as numpy arrays
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self.idx)
        bs = self.batch_size
        if self.last_batch_handle == "roll_over" and \
                self.num_data - bs < self.cursor < self.num_data:
            # the short batch left over leads the next pass's first one
            self.cursor = self.cursor - self.num_data - bs
        else:
            self.cursor = -bs
            self._cache = None

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data, label = self._batch(self.data), self._batch(self.label)
        if self._cache is not None and -self.batch_size < self.cursor < 0:
            data = [onp.concatenate([c, d]) for c, d in
                    zip(self._cache[0], data)]
            label = [onp.concatenate([c, d]) for c, d in
                     zip(self._cache[1], label)]
            self._cache = None
        if data[0].shape[0] != self.batch_size:
            # a short last batch: discarded, or kept for the next pass
            self._cache = (data, label)
            raise StopIteration
        return DataBatch(data=[_host(d) for d in data],
                         label=[_host(lb) for lb in label],
                         pad=self.getpad(), index=None)

    def _batch(self, arrays):
        """This cursor's rows of each array (numpy): the pad rows from the
        start under "pad", the rest of the pass's first batch under
        "roll_over"."""
        bs, c, n = self.batch_size, self.cursor, self.num_data
        if c < 0:
            sel = self.idx[:c + bs]
        elif self.last_batch_handle == "pad" and c + bs > n:
            sel = onp.concatenate([self.idx[c:], self.idx[:c + bs - n]])
        else:
            sel = self.idx[c:min(c + bs, n)]
        return [v[sel] for _, v in arrays]

    def getdata(self):
        return [_host(d) for d in self._batch(self.data)]

    def getlabel(self):
        return [_host(lb) for lb in self._batch(self.label)]

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            return -self.cursor
        return 0


class ResizeIter(DataIter):
    """A pass of ``size`` batches over ``data_iter``, rewinding it as
    needed (reference: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double buffering over one or more iterators (reference: io.py
    PrefetchingIter; src/io/iter_prefetcher.h:142): each
    sub-iterator's next batch is fetched on a background thread while
    the current one is consumed; a fetch's exception is raised at the
    ``next()`` that waits for it."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = iters[0].batch_size
        self.current_batch = None
        self._pool = ThreadPoolExecutor(max_workers=len(iters),
                                        thread_name_prefix="prefetching-iter")
        self._futures = []
        self._push_fetches()

    @staticmethod
    def _fetch(it):
        try:
            return it.next()
        except StopIteration:
            return None

    def _push_fetches(self):
        self._futures = [self._pool.submit(self._fetch, it)
                         for it in self.iters]

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for f in self._futures:  # drain the fetches in flight
            try:
                f.result()
            except BaseException:  # noqa: BLE001 — the pass is abandoned
                pass
        for i in self.iters:
            i.reset()
        self._push_fetches()

    def iter_next(self):
        batches = [f.result() for f in self._futures]
        if batches[0] is None:
            return False
        self.current_batch = DataBatch(
            sum([b.data for b in batches], []),
            sum([(b.label or []) for b in batches], []),
            batches[0].pad, batches[0].index)
        self._push_fetches()  # the next fetch overlaps the consumption
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class MNISTIter(NDArrayIter):
    """MNIST from its idx-ubyte files (optionally gzipped) (reference:
    src/io/iter_mnist.cc): images scaled to [0, 1], (B, 1, 28, 28) or
    flat, the last short batch discarded. A missing file raises
    FileNotFoundError (the JAX package makes random digits instead)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, input_shape=None, **kwargs):
        from ..gluon.data.vision.datasets import _find, _read_idx

        images = _read_idx(_find(image)).astype(onp.float32) / 255.0
        labels = _read_idx(_find(label)).astype(onp.float32)
        images = images.reshape(images.shape[0], -1) if flat else \
            images.reshape(images.shape[0], 1, 28, 28)
        if num_parts > 1:
            images = images[part_index::num_parts]
            labels = labels[part_index::num_parts]
        super().__init__(images, labels, batch_size=int(batch_size),
                         shuffle=bool(shuffle), last_batch_handle="discard")


class CSVIter(NDArrayIter):
    """Batches from CSV files of numbers (reference: src/io/iter_csv.cc),
    parsed with numpy; the last batch padded (``round_batch``) or
    discarded."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        def parse(path):
            return onp.loadtxt(path, delimiter=",", dtype=onp.float32,
                               ndmin=2)

        data = parse(data_csv).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = parse(label_csv).reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard")


class DevicePrefetchIter(_DeviceFeedBase):
    """``DeviceFeed`` under its older name and signature (``base, device,
    depth=2``): batches staged on ``device`` ahead of the step."""

    def __init__(self, base, device=None, depth=2):
        super().__init__(base, depth=depth, device=device)
        self.base = base
