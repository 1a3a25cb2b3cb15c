"""Device context.

The PyTorch counterpart of ``mxnet_tpu/context.py`` (reference:
python/mxnet/context.py). Device types are ``cpu`` and ``gpu``; a
Context maps to a ``torch.device``; ``cpu_shared`` (shared memory that
other processes attach to, ``ndarray/shared_mem.py``) maps to the CPU.
The default context is ``gpu(0)``:
entry points run on the card unless the caller asks for ``cpu()``.
Resolving a ``gpu`` context on a host without a CUDA device raises
:class:`MXNetError` — the port never falls back to the CPU quietly.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "cuda_graph"]


class Context:
    """Device context holding device type and id; usable as a ``with``
    scope that sets the default context (reference:
    python/mxnet/context.py:126-132)."""

    _default_ctx = threading.local()

    devstr2type = {"cpu": 1, "gpu": 2, "cpu_shared": 5}
    devtype2str = {1: "cpu", 2: "gpu", 5: "cpu_shared"}

    def __init__(self, device_type, device_id=0):
        if device_type not in Context.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r} "
                             "(expected 'cpu', 'gpu' or 'cpu_shared')")
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @property
    def torch_device(self):
        """The ``torch.device`` backing this context. Raises
        :class:`MXNetError` for a ``gpu`` context when no CUDA device
        (or not that many) is present."""
        if self.device_type in ("cpu", "cpu_shared"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"context {self} needs a CUDA device and none is present; "
                "pass ctx=mx.cpu() to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(
                f"context {self} names CUDA device {self.device_id} but "
                f"only {torch.cuda.device_count()} are present")
        return torch.device("cuda", self.device_id)

    @classmethod
    def from_device(cls, device):
        """The Context of a ``torch.device`` (or a tensor's device)."""
        device = torch.device(device)
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        if device.type == "cpu":
            return cls("cpu", 0)
        raise MXNetError(f"unsupported torch device {device}")


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The scoped default context; ``gpu(0)`` outside any scope."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)


def resolve_device(ctx=None):
    """``torch.device`` for ``ctx`` (default: the current context)."""
    if ctx is None:
        ctx = current_context()
    elif not isinstance(ctx, Context):
        ctx = Context.from_device(ctx)
    return ctx.torch_device


def host_to_device(t, device):
    """A host tensor on ``device``. To a CUDA device the copy goes through
    pinned memory without blocking the host (a copy from pageable memory
    waits for the stream); torch keeps the pinned block until the copy
    has run."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@contextlib.contextmanager
def cuda_graph(graph, **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` with Python's cyclic garbage
    collector paused for the capture (``torch.cuda.graph`` collects just
    before it begins): a collection inside the capture can free an
    unreachable CUDA graph of earlier work, whose teardown a capturing
    stream does not permit, and the capture fails."""
    from .utils import compile_cache as _cc

    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
        # a CUDA graph cannot be persisted: every process captures its
        # own, and the compile cache counts them
        _cc.note_capture()
    finally:
        if enabled:
            gc.enable()
