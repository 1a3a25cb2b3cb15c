"""General utilities (reference: python/mxnet/util.py).

The PyTorch counterpart of ``mxnet_tpu/util.py``: the NumPy-semantics
switches (``np_shape`` / ``np_array`` / ``use_np*``) as context
managers and decorators, and the small filesystem and introspection
helpers the reference exposes at ``mx.util``. The JAX package keeps the
switches' state in ``numpy_extension``; the port keeps it here until
``numpy_extension`` is ported (slice 11).
"""
from __future__ import annotations

import functools
import os

__all__ = ["makedirs", "set_np_shape", "is_np_shape", "np_shape",
           "use_np_shape", "np_array", "is_np_array", "use_np_array",
           "use_np", "set_np", "reset_np", "set_module", "wraps_safely",
           "get_gpu_count", "get_gpu_memory"]

_STATE = {"np_shape": False, "np_array": False}


def makedirs(d):
    """mkdir -p (reference: util.py makedirs)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count():
    """Number of CUDA devices (reference: util.py get_gpu_count)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_gpu_memory(gpu_dev_id=0):
    """(free, total) memory of CUDA device ``gpu_dev_id`` in bytes
    (reference: cudaMemGetInfo), through
    ``storage.device_memory_info``."""
    if gpu_dev_id >= get_gpu_count():
        raise ValueError(f"no accelerator device {gpu_dev_id}")
    from .context import Context
    from .storage import device_memory_info

    free, total, _ = device_memory_info(Context("gpu", gpu_dev_id))
    return free, total


# ---- NumPy-semantics switches -------------------------------------------

def set_np_shape(active):
    """Enable/disable NumPy shape semantics (zero-dim and zero-size
    arrays). Returns the previous state (reference: util.py
    set_np_shape)."""
    prev = _STATE["np_shape"]
    _STATE["np_shape"] = bool(active)
    return prev


def is_np_shape():
    return _STATE["np_shape"]


def is_np_array():
    return _STATE["np_array"]


def set_np(shape=True, array=True):
    """Activate NumPy-semantics mode (reference: util.py set_np)."""
    _STATE["np_shape"], _STATE["np_array"] = bool(shape), bool(array)


def reset_np():
    set_np(shape=False, array=False)


class _Scope:
    """Context manager and decorator toggling one switch (reference
    _NumpyShapeScope/_NumpyArrayScope)."""

    def __init__(self, key, active):
        self._key = key
        self._active = bool(active)
        self._prev = None

    def __enter__(self):
        self._prev = _STATE[self._key]
        _STATE[self._key] = self._active
        return self

    def __exit__(self, *exc):
        _STATE[self._key] = self._prev
        return False

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with _Scope(self._key, self._active):
                return func(*args, **kwargs)

        return wrapper


def np_shape(active=True):
    """``with np_shape():`` or ``@np_shape()`` (reference util.np_shape)."""
    return _Scope("np_shape", active)


def np_array(active=True):
    return _Scope("np_array", active)


def use_np_shape(func):
    """Run ``func`` under NumPy shape semantics."""
    return np_shape(True)(func)


def use_np_array(func):
    """Run ``func`` under NumPy array semantics."""
    return np_array(True)(func)


def use_np(func_or_cls):
    """``use_np_shape`` and ``use_np_array`` (reference util.py use_np);
    a class passes through, as in the JAX package."""
    if isinstance(func_or_cls, type):
        return func_or_cls
    return use_np_array(use_np_shape(func_or_cls))


def wraps_safely(wrapped, assigned=functools.WRAPPER_ASSIGNMENTS):
    """functools.wraps tolerating missing attributes (reference:
    util.py wraps_safely)."""
    present = [a for a in assigned if hasattr(wrapped, a)]
    return functools.wraps(wrapped, assigned=present)


def set_module(module):
    """Decorator overriding __module__ for doc tooling (reference:
    util.py set_module)."""

    def deco(obj):
        if module is not None:
            obj.__module__ = module
        return obj

    return deco
