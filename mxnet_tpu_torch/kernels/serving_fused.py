"""Serving specialization: the bucket pad and slice of device inputs.

The PyTorch counterpart of ``mxnet_tpu/kernels/serving_fused.py``:
``InferenceSession._run_bucket`` pads device inputs up to the bucket's
rows and slices padded outputs back. Here each side is one torch op per
array (a zero-fill pad, a view), with the semantics of the JAX helpers:
zero rows after the data, and only outputs padded along axis 0 shrink.
The session always calls both; where the JAX package chose between a
fused and a per-array executable, the only thing the ``serving`` entry
of ``MXNET_FUSION_PATTERNS`` and the ``MXNET_FUSION`` kill switch gate
here is the counters ``serving_pad_fused`` and ``serving_slice_fused``.
The artifact tier of the JAX helpers (disk-cached executables) waits for
the platform slice.
"""
from __future__ import annotations

import torch.nn.functional as F

from . import _count, enabled_patterns, fusion_enabled

__all__ = ["serving_fusion_enabled", "pad_all", "slice_all"]


def serving_fusion_enabled():
    """True when the serving pad/slice specialization is armed."""
    return fusion_enabled() and "serving" in enabled_patterns()


def pad_all(datas, bucket):
    """Every tensor in ``datas`` padded with zero rows to ``bucket``
    rows along axis 0."""
    if all(d.shape[0] == bucket for d in datas):
        return list(datas)
    if serving_fusion_enabled():
        _count("serving_pad_fused")
    return [F.pad(d, (0, 0) * (d.dim() - 1) + (0, bucket - d.shape[0]))
            for d in datas]


def slice_all(outs, bucket, true):
    """The inverse of :func:`pad_all`: outputs with ``bucket`` rows cut
    to their first ``true`` rows (views); anything else passes
    through."""
    if bucket == true:
        return list(outs)
    if serving_fusion_enabled():
        _count("serving_slice_fused")
    return [o[:true] if o.dim() and o.shape[0] == bucket else o
            for o in outs]
