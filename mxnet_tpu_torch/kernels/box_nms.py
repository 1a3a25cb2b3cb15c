"""The greedy sweep of ``box_nms`` and its CUDA kernel N1.

``box_nms`` (``ndarray/ops_contrib.py``) sorts the rows by score, then
sweeps them greedily: each row still kept clears every later row whose
IoU with it exceeds the threshold (within its class unless
``force_suppress``). The JAX op writes the sweep as a ``lax.fori_loop``
over all N rows (``mxnet_tpu/ndarray/ops_contrib.py:82-88``), one device
program under XLA. Here:

- :func:`_nms_keep_cuda` is the wrapper of N1, ``csrc/box_nms.cu``: one
  thread block per image sweeps the rows with its keep flags in shared
  memory, a barrier after each kept row. N1 is not a port of a Pallas
  kernel: the JAX package has none on this path.
- :func:`_nms_keep_ref` is its plain version, the JAX loop in torch: a
  Python loop over the rows, batched over the images.

The wrapper follows the port's rule: on a CPU tensor it runs the plain
version, on a ``meta`` tensor it returns an empty mask (so shape
inference sees through ``box_nms``), on a CUDA tensor it launches N1 or
raises. It syncs nothing with the host, so a captured graph can hold it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from ..ndarray.ops_contrib import _corner_iou
from . import _build

__all__ = ["KERNEL", "_nms_keep_ref", "_nms_keep_cuda"]

KERNEL = "box_nms"  # N1


def _nms_keep_ref(boxes, valid, ids, thresh, limit):
    """Plain version of N1: the keep mask (B, N) of the greedy sweep over
    the score-sorted corner ``boxes`` (B, N, 4). A row is kept if it is
    ``valid``, lies before ``limit`` and no earlier kept row overlaps it
    by an IoU above ``thresh``; with class ids ``ids`` (B, N), rows of
    different classes overlap by 0. Row i's IoUs are the row the JAX op
    reads from its (N, N) matrix, computed alone."""
    N = valid.shape[1]
    ar = torch.arange(N, device=valid.device)
    keep = valid & (ar < limit)[None, :]
    for i in range(limit):
        o = _corner_iou(boxes[:, i:i + 1], boxes)[:, 0]  # (B, N)
        if ids is not None:
            o = torch.where(ids[:, i:i + 1] == ids, o, 0.0)
        keep = keep & ~((o > thresh) & keep[:, i:i + 1] & (ar > i)[None, :])
    return keep


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load(KERNEL).mxtt_box_nms
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _nms_keep_cuda(boxes, valid, ids, thresh, limit):
    """N1: the keep mask (B, N) bool of the greedy sweep; the contract of
    :func:`_nms_keep_ref`.

    On CPU tensors this is the plain version; on meta tensors an empty
    mask. On CUDA tensors it launches N1 on the current stream, without
    synchronizing, or raises: boxes (B, N, 4) float32, valid (B, N) bool
    and ids (B, N) float32 or None, contiguous, on one device, with
    0 <= limit <= N (boxes not 16-byte aligned are copied first)."""
    ts = (boxes, valid) + (() if ids is None else (ids,))
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise MXNetError(f"_nms_keep_cuda: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return _nms_keep_ref(boxes, valid, ids, thresh, limit)
    if dev.type == "meta":
        return torch.empty(valid.shape, dtype=torch.bool, device=dev)
    if dev.type != "cuda":
        raise MXNetError(f"_nms_keep_cuda: unsupported device {dev}")
    if valid.dim() != 2 or tuple(boxes.shape) != tuple(valid.shape) + (4,) \
            or (ids is not None and ids.shape != valid.shape):
        raise MXNetError(
            "_nms_keep_cuda: boxes must be (B, N, 4), valid and ids (B, N); "
            f"got {tuple(boxes.shape)}, {tuple(valid.shape)}, "
            f"{None if ids is None else tuple(ids.shape)}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool or \
            (ids is not None and ids.dtype != torch.float32):
        raise MXNetError(
            "_nms_keep_cuda: the kernel takes float32 boxes and ids and a "
            f"bool mask, got {boxes.dtype}, {valid.dtype}, "
            f"{None if ids is None else ids.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise MXNetError("_nms_keep_cuda: inputs must be contiguous")
    B, N = valid.shape
    if not 0 <= limit <= N:
        raise MXNetError(f"_nms_keep_cuda: limit {limit} not in [0, {N}]")
    if boxes.data_ptr() % 16:
        # a contiguous view at an odd offset (a slice of a one-row
        # array): the kernel reads a box as one 16-byte load
        boxes = boxes.clone()
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    if B == 0 or N == 0:
        return keep
    with torch.cuda.device(dev):
        err = _entry()(boxes.data_ptr(), valid.data_ptr(),
                       None if ids is None else ids.data_ptr(),
                       keep.data_ptr(), B, N, int(limit), float(thresh),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"_nms_keep_cuda: kernel launch failed with CUDA "
                         f"error {err}")
    _build.count_launch(KERNEL)
    return keep
