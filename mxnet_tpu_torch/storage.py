"""Pooled host storage manager (reference: include/mxnet/storage.h,
src/storage/pooled_storage_manager.h: exact-size bucket recycling with
env-tunable behaviour).

The PyTorch counterpart of ``mxnet_tpu/storage.py``. The card's memory
belongs to torch's CUDA caching allocator; this pool
(``csrc/engine.cc:PooledStorage``) manages host buffers (IO batch
staging, record chunks), where the reference used its CPU managers.
``MXNET_GPU_MEM_POOL_TYPE`` (Naive, Round, Unpooled) and
``MXNET_GPU_MEM_POOL_RESERVE`` steer this host pool, as in the JAX
package; ``MXNET_CPU_MEM_POOL_DISABLE=1`` bypasses it (a plain buffer
per allocation). :func:`device_memory_info` fronts the card's
accounting.
"""
from __future__ import annotations

import ctypes
import os

import numpy as onp

__all__ = ["Storage", "get", "device_memory_info"]


class _Handle:
    __slots__ = ("ptr", "size")

    def __init__(self, ptr, size):
        self.ptr = ptr
        self.size = size


class Storage:
    def __init__(self):
        from . import _native
        from . import env as _env

        self._lib = _native.engine_lib()  # a failed build raises
        # strategy + reserve knobs (reference MXNET_GPU_MEM_POOL_TYPE /
        # _RESERVE steer the GPU pool; the card's memory belongs to
        # torch's caching allocator, so they steer this host pool —
        # Round = pow2 buckets, Naive = exact-size, Unpooled = plain
        # malloc/free)
        strategy = {"Naive": 0, "Round": 1, "Unpooled": 2}.get(
            _env.get_str("MXNET_GPU_MEM_POOL_TYPE", "Naive"), 0)
        reserve = _env.get_int("MXNET_GPU_MEM_POOL_RESERVE", 0)
        cap = -1
        if reserve > 0:
            try:  # keep at most (100-reserve)% of phys mem pooled
                page = os.sysconf("SC_PAGE_SIZE")
                phys = os.sysconf("SC_PHYS_PAGES") * page
                cap = phys * max(0, 100 - reserve) // 100
            except (ValueError, OSError):
                cap = -1
        self._h = self._lib.pool_create2(strategy, cap)
        self._fallback = {}

    @property
    def native(self):
        return True

    def alloc(self, size):
        """→ handle with .ptr/.size (reference: Storage::Alloc)."""
        from . import env as _env

        if not _env.get_bool("MXNET_CPU_MEM_POOL_DISABLE"):
            ptr = self._lib.pool_alloc(self._h, int(size))
            if ptr:
                return _Handle(ptr, size)
        buf = ctypes.create_string_buffer(int(size))
        h = _Handle(ctypes.addressof(buf), size)
        self._fallback[h.ptr] = buf
        return h

    def free(self, handle):
        """Return to the pool (reference: Storage::Free)."""
        if handle.ptr in self._fallback:
            del self._fallback[handle.ptr]
            return
        self._lib.pool_free(self._h, handle.ptr)

    def direct_free(self, handle):
        if handle.ptr in self._fallback:
            del self._fallback[handle.ptr]
            return
        self._lib.pool_direct_free(self._h, handle.ptr)

    def release_all(self):
        self._lib.pool_release_all(self._h)

    def stats(self):
        """→ dict(used_bytes, pooled_bytes, total_mallocs)."""
        out = (ctypes.c_int64 * 3)()
        self._lib.pool_stats(self._h, out)
        return {"used_bytes": int(out[0]), "pooled_bytes": int(out[1]),
                "total_mallocs": int(out[2])}

    def as_array(self, handle, shape, dtype=onp.uint8):
        """Zero-copy numpy view of a pooled buffer (IO staging)."""
        n = int(onp.prod(shape)) * onp.dtype(dtype).itemsize
        if n > handle.size:
            raise ValueError(f"a view of {n} bytes over a buffer of "
                             f"{handle.size}")
        buf = (ctypes.c_ubyte * handle.size).from_address(handle.ptr)
        return onp.frombuffer(buf, dtype=dtype,
                              count=int(onp.prod(shape))).reshape(shape)


_storage = None


def device_memory_info(ctx=None):
    """(free, total, stats) of a device's memory through the Storage
    interface (reference: Storage::Get / cudaMemGetInfo behind
    mx.context.gpu_memory_info). For ``gpu(i)`` (the default when a card
    is present): ``torch.cuda.mem_get_info`` and the caching
    allocator's ``memory_stats``. For the CPU, what the JAX function
    returns for a device without a byte limit: (0, 0, {})."""
    import torch

    from .context import Context

    if ctx is None:
        ctx = Context("gpu", 0) if torch.cuda.is_available() else \
            Context("cpu", 0)
    elif not isinstance(ctx, Context):
        dev = torch.device(ctx)
        ctx = Context("gpu" if dev.type == "cuda" else "cpu",
                      dev.index or 0)
    if ctx.device_type != "gpu":
        return 0, 0, {}
    dev = ctx.torch_device
    free, total = torch.cuda.mem_get_info(dev)
    return int(free), int(total), dict(torch.cuda.memory_stats(dev))


def get():
    """Singleton (reference: Storage::Get())."""
    global _storage
    if _storage is None:
        _storage = Storage()
    return _storage
