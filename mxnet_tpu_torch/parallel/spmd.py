"""All-reduce across ranks, coalesced by dtype, and over local devices.

The PyTorch counterpart of ``mxnet_tpu/parallel/spmd.py:35-165``
(reference: kvstore_nccl.h ncclAllReduce, comm.h CommDevice::Reduce).
Outside a process group ``all_reduce`` is the identity, as in the JAX
package's single process; inside one (``tools/launch.py``) it is
``torch.distributed.all_reduce`` with ``SUM`` over the group (NCCL, or
gloo by the launcher's rule), a group of one rank included, so a
one-rank NCCL job runs NCCL's collective for real.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["all_reduce", "all_reduce_coalesced", "group_all_reduce",
           "all_reduce_async", "flatten", "unflatten"]


def _grouped():
    from .. import _rendezvous

    return _rendezvous.is_initialized()


def _tensor(x):
    return x.data if isinstance(x, NDArray) else x


def all_reduce_async(flat):
    """Start ``dist.all_reduce(flat, SUM)`` in place and return its work
    handle; the caller waits on it before reading ``flat``."""
    import torch.distributed as dist

    return dist.all_reduce(flat, op=dist.ReduceOp.SUM, async_op=True)


def _reduce_in_place(flat):
    import torch.distributed as dist

    with torch.no_grad():
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return flat


def all_reduce(x, axis_name=None):
    """The sum of ``x`` (an NDArray or a tensor) over the ranks, as a new
    value of the same kind; ``x`` itself outside a process group.
    ``axis_name``
    (a mesh axis inside a sharded region) comes with slice 9b."""
    if axis_name is not None:
        raise MXNetError("all_reduce over a mesh axis comes with slice 9b "
                         "(the single-controller mesh)")
    if not _grouped():
        return x
    import torch.distributed as dist

    t = _tensor(x)
    with torch.no_grad():
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return NDArray(out) if isinstance(x, NDArray) else out


def flatten(tensors):
    """One flat tensor of ``tensors`` (one dtype, one device), in order."""
    with torch.no_grad():
        if len(tensors) == 1:
            return tensors[0].detach().reshape(-1).clone()
        return torch.cat([t.detach().reshape(-1) for t in tensors])


def unflatten(flat, tensors):
    """Views of ``flat`` shaped as ``tensors``, in order."""
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape))
        off += n
    return out


def all_reduce_coalesced(values, reduce_fn=None):
    """Sum a list of values over the ranks with one collective per dtype
    (and device) instead of one per value: each group is flattened in
    list order, reduced, and split back. The reduction is elementwise,
    so the result is bitwise the per-value ``all_reduce``'s whatever the
    grouping. ``reduce_fn(flat)`` replaces the collective (it returns
    the reduced flat tensor); with the default, a process outside a group
    returns the values as they are."""
    values = list(values)
    if reduce_fn is None:
        if not _grouped():
            return values
        reduce_fn = _reduce_in_place
    groups = {}
    for i, v in enumerate(values):
        t = _tensor(v)
        groups.setdefault((t.dtype, t.device), []).append(i)
    out = [None] * len(values)
    for idxs in groups.values():
        ts = [_tensor(values[i]) for i in idxs]
        red = _tensor(reduce_fn(flatten(ts)))
        for i, r in zip(idxs, unflatten(red, ts)):
            out[i] = r
    return [NDArray(o) if isinstance(v, NDArray) else o
            for v, o in zip(values, out)]


def group_all_reduce(values):
    """The sum of a list of values that live one on each of several
    devices of this process, one copy on each value's device (reference:
    kvstore_nccl.h's group all-reduce). Values that share a device raise
    :class:`MXNetError`; a kvstore then sums them serially."""
    values = list(values)
    if len(values) == 1:
        return values
    ts = [_tensor(v) for v in values]
    devices = []
    for t in ts:
        if t.device in devices:
            raise MXNetError(
                "group_all_reduce expects one value per distinct device")
        devices.append(t.device)
    with torch.no_grad():
        total = ts[0].detach().clone()
        for t in ts[1:]:
            total += t.detach().to(devices[0])
        outs = [total if d == devices[0] else total.to(d) for d in devices]
    return [NDArray(o) if isinstance(v, NDArray) else o
            for v, o in zip(values, outs)]
