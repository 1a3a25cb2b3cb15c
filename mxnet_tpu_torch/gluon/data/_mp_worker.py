"""Process workers for the DataLoader, with batches handed back through
shared memory.

The PyTorch counterpart of ``mxnet_tpu/gluon/data/_mp_worker.py``
(reference: python/mxnet/gluon/data/dataloader.py:28-156, whose NDArray
pickling rides POSIX shared memory). A worker makes a batch, writes
each array leaf into a ``multiprocessing.shared_memory`` block and
returns ``(name, shape, dtype)`` descriptors; the parent copies each
block into a host NDArray and unlinks it. No tensor bytes go through a
pipe. Workers touch no CUDA device.
"""
from __future__ import annotations

from multiprocessing import shared_memory

import numpy as onp

_WORKER_DATASET = None
_WORKER_BATCHIFY = None


def _init_worker(dataset, batchify_fn):
    """Runs once per worker process: holds the dataset and batchify
    function, and keeps torch to one thread per worker."""
    global _WORKER_DATASET, _WORKER_BATCHIFY
    import torch

    torch.set_num_threads(1)
    _WORKER_DATASET = dataset
    _WORKER_BATCHIFY = batchify_fn


def _to_shm(arr):
    """numpy array -> (shm name, shape, dtype). The worker closes its
    handle; the parent unlinks the block."""
    arr = onp.ascontiguousarray(arr)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    view = onp.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
    view[:] = arr
    name = shm.name
    del view
    shm.close()
    return (name, arr.shape, str(arr.dtype))


def _from_shm(desc):
    name, shape, dtype = desc
    shm = shared_memory.SharedMemory(name=name)
    view = onp.ndarray(shape, onp.dtype(dtype), buffer=shm.buf)
    arr = view.copy()
    del view
    shm.close()
    shm.unlink()
    return arr


def _encode(obj):
    """A batch with its array leaves (NDArray or numpy) replaced by shared
    memory descriptors."""
    if hasattr(obj, "asnumpy"):
        return ("__shm__", _to_shm(obj.asnumpy()))
    if isinstance(obj, onp.ndarray):
        return ("__shm__", _to_shm(obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    return obj


def decode(obj):
    """Parent side: descriptors back to host NDArrays."""
    from ...ndarray import NDArray
    from ...ndarray.ndarray import host_tensor

    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "__shm__":
        return NDArray(host_tensor(_from_shm(obj[1])))
    if isinstance(obj, (list, tuple)):
        return type(obj)(decode(x) for x in obj)
    if isinstance(obj, dict):
        return {k: decode(v) for k, v in obj.items()}
    return obj


def worker_make_batch(indices):
    """In the worker: fetch the samples, batchify, export through shared
    memory."""
    return _encode(_WORKER_BATCHIFY([_WORKER_DATASET[i] for i in indices]))
