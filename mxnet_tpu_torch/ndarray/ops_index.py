"""Index ops: ``pick``.

The PyTorch counterpart of ``mxnet_tpu/ndarray/ops_index.py:35``, cut
to the op the softmax cross-entropy loss calls.
"""
from __future__ import annotations

import torch

from .registry import register


@register()
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis``, one element per position of
    the other axes (reference: broadcast_reduce_op_index.cc pick). An
    out-of-range index is clipped (``mode="clip"``, the only mode
    ported). ``index`` may be a float array, as MXNet labels often
    are."""
    if mode != "clip":
        raise ValueError(f"pick: only mode='clip' is ported, got {mode!r}")
    axis = axis % data.dim()
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
