"""Base utilities for mxnet_tpu_torch.

The PyTorch counterpart of ``mxnet_tpu/base.py``: errors are plain
Python exceptions, mirroring ``mxnet.base.MXNetError`` (reference:
python/mxnet/base.py:87).
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Default error thrown by mxnet_tpu_torch functions."""

