"""Base utilities for mxnet_tpu_torch.

The PyTorch counterpart of ``mxnet_tpu/base.py``: errors are plain
Python exceptions, mirroring ``mxnet.base.MXNetError`` (reference:
python/mxnet/base.py:87).
"""
from __future__ import annotations

import os

__all__ = ["MXNetError", "getenv"]


class MXNetError(RuntimeError):
    """Default error thrown by mxnet_tpu_torch functions."""


def getenv(name, default, kind=str):
    """The ``MXNET_*`` knob ``name`` read as ``kind`` (``int``, ``float``,
    ``bool`` or ``str``); ``default`` when it is unset or empty. As in
    ``mxnet_tpu/env.py``, a boolean knob is false for "0" and "false"
    and true for anything else."""
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    if kind is bool:
        return raw not in ("0", "false", "False")
    return kind(raw)

