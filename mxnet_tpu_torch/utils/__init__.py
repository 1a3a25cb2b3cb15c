"""``gluon.utils``' functions.

The PyTorch counterpart of ``mxnet_tpu/utils/__init__.py:20-97``
(reference: python/mxnet/gluon/utils.py): ``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1`` and
``download``. ``clip_global_norm`` reads the global norm on the host,
as the JAX package does, and scales each array in place, into the
tensor its handle owns (``NDArray.__imul__``), so a captured graph that
reads a gradient buffer sees the clipped values. ``download`` fetches
nothing: it returns the file when it is already there and raises
otherwise. The ``MXNET_*`` knobs are read by ``base.getenv``.
"""
from __future__ import annotations

import hashlib
import math
import os
import warnings

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis``; the
    last takes the remainder unless ``even_split`` demands none
    (reference: gluon/utils.py split_data)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis`` and each slice copied to its
    context of ``ctx_list`` (reference: gluon/utils.py split_and_load)."""
    from .. import ndarray as nd
    from ..ndarray import NDArray

    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint 2-norm is at most
    ``max_norm``; returns the norm before clipping, a float (reference:
    gluon/utils.py clip_global_norm). Nothing is written when the scale
    is at least 1, or when the norm is not finite (a warning then)."""
    from .. import ndarray as nd

    total = 0.0
    for arr in arrays:
        total += float(nd.norm(arr).asscalar()) ** 2
    total = math.sqrt(total)
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf is detected.")
        return total
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr.__imul__(scale)
    return total


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local file ``url`` would be saved as (reference:
    gluon/utils.py download). Nothing is fetched: the file must already
    be there, else this raises ``RuntimeError``."""
    fname = path or url.split("/")[-1]
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if os.path.exists(fname) and not overwrite:
        return fname
    raise RuntimeError(f"download of {url} unavailable: this package "
                       f"fetches nothing; place the file at {fname}")
