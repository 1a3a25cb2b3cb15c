"""NDArrays in shared memory (``ctx=mx.Context("cpu_shared")``).

The PyTorch counterpart of ``mxnet_tpu/ndarray/shared_mem.py``
(reference: src/storage/cpu_shared_storage_manager.h and the
``cpu_shared`` context, which back an NDArray with POSIX shared memory
so that DataLoader workers hand batches to the trainer without a copy
through a pipe; python/mxnet/gluon/data/dataloader.py:28-90
reduce_ndarray/rebuild_ndarray).

A ``SharedNDArray``'s tensor is ``torch.frombuffer`` over a
``multiprocessing.shared_memory`` segment, so an in-place write (``a[:]
= ...``, ``+=``, ``copyto``) lands in the segment and every process
attached to it sees it. Pickling sends ``(name, shape, dtype)``; the
receiving process attaches to the same segment. The creating process
owns the segment and unlinks it when its array is collected; an attached
process only closes its mapping, and takes the segment off its resource
tracker, which would otherwise unlink it when that process exits
(Python before 3.13 registers attached segments too). Results of ops on
a shared array are ordinary CPU arrays.
"""
from __future__ import annotations

import weakref
from multiprocessing import resource_tracker, shared_memory

import numpy as onp
import torch

from .ndarray import NDArray, torch_dtype

__all__ = ["SharedNDArray", "shared_empty", "to_shared"]


class SharedNDArray(NDArray):
    """An NDArray whose memory is a named shared-memory segment."""

    __slots__ = ("_shm", "_owner")

    def __init__(self, shm, shape, dtype, owner):
        dt = torch_dtype(dtype)
        n = 1
        for d in shape:
            n *= int(d)
        t = torch.empty((0,), dtype=dt)
        if n:
            # the segment's storage in the array's shape, not a view of a
            # flat tensor: in-place operators write into it (``_owns``)
            t.set_(torch.frombuffer(shm.buf, dtype=dt, count=n)
                   .untyped_storage(), 0, tuple(shape))
        super().__init__(t.reshape(tuple(shape)) if not n else t)
        self._shm = shm
        self._owner = owner
        weakref.finalize(self, _cleanup_owner if owner else _cleanup_attached,
                         shm)

    @property
    def shm_name(self):
        return self._shm.name

    @property
    def context(self):
        from ..context import Context

        return Context("cpu_shared", 0)

    ctx = context

    def __reduce__(self):
        """Pickling sends the segment's name, not its bytes (reference:
        reduce_ndarray)."""
        return (_rebuild, (self._shm.name, self.shape,
                           str(self._data.dtype).replace("torch.", "")))


def _cleanup_owner(shm):
    _cleanup_attached(shm)
    try:
        shm.unlink()
    except OSError:
        pass


def _cleanup_attached(shm):
    try:  # BufferError: the tensor's view may outlive the handle
        shm.close()
    except (OSError, BufferError):
        pass


# the segments this process created (their tracker entries are its own)
_CREATED = set()


def _rebuild(name, shape, dtype):
    shm = shared_memory.SharedMemory(name=name)
    if shm._name not in _CREATED:
        # the creating process owns the segment's lifetime
        resource_tracker.unregister(shm._name, "shared_memory")
    return SharedNDArray(shm, shape, dtype, owner=False)


def shared_empty(shape, dtype="float32"):
    """An uninitialized array in a new shared-memory segment (reference:
    NDArray(shape, Context::CPUShared()))."""
    dt = torch_dtype(dtype)
    n = 1
    for d in shape:
        n *= int(d)
    nbytes = max(1, n * torch.empty((), dtype=dt).element_size())
    shm = shared_memory.SharedMemory(create=True, size=nbytes)
    _CREATED.add(shm._name)
    return SharedNDArray(shm, tuple(shape), dt, owner=True)


def to_shared(source):
    """A copy of ``source`` (an NDArray, a tensor, a numpy array or a
    nested list) in shared memory; a SharedNDArray as it is."""
    if isinstance(source, SharedNDArray):
        return source
    if isinstance(source, NDArray):
        t = source.data.detach().cpu()
    elif isinstance(source, torch.Tensor):
        t = source.detach().cpu()
    else:  # numpy's dtype, as it is (the JAX ``to_shared`` keeps it)
        t = torch.from_numpy(onp.ascontiguousarray(onp.asarray(source)))
    out = shared_empty(tuple(t.shape), t.dtype)
    out._data.copy_(t)
    return out
