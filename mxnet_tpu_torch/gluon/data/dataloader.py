"""DataLoader.

The PyTorch counterpart of ``mxnet_tpu/gluon/data/dataloader.py``
(reference: python/mxnet/gluon/data/dataloader.py: worker pool,
shared-memory batches, ``worker_loop`` :207). Batches are host (CPU)
NDArrays, as in MXNet; ``pipeline.DeviceFeed`` stages them onto the
card. Workers are threads by default, as in the JAX package (decode,
augment and batchify release the GIL inside numpy and torch), or
processes (``thread_pool=False``) that hand batches back through POSIX
shared memory (``_mp_worker.py``). The JAX package collects worker
results through its dependency engine, which the port has not yet
(slice 10); here the consumer waits on the futures in order.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from concurrent.futures.process import BrokenProcessPool

import numpy as onp
import torch

from ...base import getenv
from ...ndarray import NDArray
from ...ndarray.ndarray import host_tensor
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: dataloader.py
    default_batchify_fn): NDArrays with ``stack`` on their device, tuples
    field by field, anything else through numpy into a host NDArray
    (float64 narrowed to float32). The stack is not an op of the
    registry: batching is outside any recorded graph and AMP policy."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d.data for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    return NDArray(host_tensor(onp.asarray(data)))


def _pin(batch):
    """Every host tensor of a batch in page-locked memory (for a
    non-blocking copy to the card)."""
    if isinstance(batch, NDArray):
        t = batch.data
        return NDArray(t.pin_memory()) if t.device.type == "cpu" else batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch


class DataLoader:
    """Loads batches from a dataset (reference: dataloader.py
    DataLoader).

    ``last_batch``: ``"keep"`` (default), ``"discard"`` or
    ``"rollover"``. ``num_workers`` None reads ``MXNET_MP_WORKER_NTHREADS``
    (default 0: batches are made inline); workers are threads unless
    ``thread_pool=False``. ``prefetch`` is how many batches may be in
    flight ahead of the consumer: None reads ``MXNET_DATALOADER_PREFETCH``,
    default ``2 * num_workers``, at least 1 with workers. ``timeout``
    (seconds, default 120) bounds the wait for one worker batch: a
    longer wait raises RuntimeError; ``<= 0`` or None waits forever.
    ``pin_memory=True`` puts each batch in page-locked host memory (where
    a CUDA device is present; without one there is nothing to pin for),
    so ``DeviceFeed``'s copy to the card does not block the host."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=None, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=True, timeout=120):
        self._dataset = dataset
        self._pin_memory = bool(pin_memory) and torch.cuda.is_available()
        self._timeout = None if timeout is None or timeout <= 0 \
            else float(timeout)
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        if num_workers is None:
            num_workers = getenv("MXNET_MP_WORKER_NTHREADS", 0, int)
        self._num_workers = num_workers
        if prefetch is None:
            prefetch = getenv("MXNET_DATALOADER_PREFETCH",
                              2 * max(num_workers, 1), int)
        self._prefetch = max(0, int(prefetch))
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._decode = None
        if num_workers > 0 and not thread_pool:
            # processes from a forkserver: they start from a clean server
            # process (forking a live CUDA context is unsafe) and do not
            # re-import __main__
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            from . import _mp_worker

            try:
                ctx = multiprocessing.get_context("forkserver")
            except ValueError:
                ctx = multiprocessing.get_context("spawn")
            self._pool = ProcessPoolExecutor(
                max_workers=num_workers, mp_context=ctx,
                initializer=_mp_worker._init_worker,
                initargs=(self._dataset, self._batchify_fn))
            self._decode = _mp_worker.decode
            self._submit_fn = _mp_worker.worker_make_batch
        elif num_workers > 0:
            self._pool = ThreadPoolExecutor(max_workers=num_workers)
            self._submit_fn = self._make_batch
        else:
            self._pool = None

    def _make_batch(self, indices):
        batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pin(batch) if self._pin_memory else batch

    def _collect(self, fut):
        try:
            b = fut.result(timeout=self._timeout)
        except FuturesTimeoutError:
            fut.cancel()
            raise RuntimeError(
                f"DataLoader worker batch took longer than "
                f"timeout={self._timeout}s (hung decode or dead worker); "
                "raise the timeout= constructor argument for slow "
                "datasets") from None
        except BrokenProcessPool:
            raise RuntimeError(
                "DataLoader process workers died. Process workers need the "
                "script's entry point guarded with `if __name__ == "
                "'__main__':`, and a picklable dataset; thread_pool=True "
                "runs thread workers instead") from None
        if self._decode is not None:
            b = self._decode(b)
            if self._pin_memory:
                b = _pin(b)
        return b

    def __iter__(self):
        if self._pool is None:
            for batch_indices in self._batch_sampler:
                yield self._make_batch(batch_indices)
            return
        depth = max(1, self._prefetch)
        pending = collections.deque()
        it = iter(self._batch_sampler)

        def submit():
            try:
                indices = list(next(it))
            except StopIteration:
                return False
            pending.append(self._pool.submit(self._submit_fn, indices))
            return True

        for _ in range(depth):
            if not submit():
                break
        try:
            while pending:
                batch = self._collect(pending.popleft())
                submit()
                yield batch
        finally:
            for fut in pending:  # an abandoned pass: drop what is queued
                fut.cancel()

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
