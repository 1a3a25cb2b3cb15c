"""``mx.nd.contrib``: control flow (foreach / while_loop / cond) and the
contrib-named ops.

The PyTorch counterpart of ``mxnet_tpu/ndarray/contrib.py`` (reference:
python/mxnet/ndarray/contrib.py). The port runs eagerly, so the control
flow is the JAX package's concrete path: ``foreach`` an unrolled Python
loop whose every op lands on the tape, ``while_loop`` a Python loop that
reads its condition on the host (the actual trip count), ``cond`` a
Python branch. The JAX package's traced branches (``lax.scan``,
``lax.while_loop``, ``lax.cond``) have no counterpart: a loop whose trip
count depends on the data cannot be captured in a CUDA graph, and
``while_loop``/``cond`` read their predicate on the host.

``_CONTRIB_OPS`` lists the registered ops exposed here, the JAX
package's list, and ``_CONTRIB_ALIASES`` their CamelCase spellings;
:func:`_install` raises on a listed name that is not registered, as the
JAX package's does. ``reset_arrays`` zeroes its inputs in place, the
reference's contract.
"""
from __future__ import annotations

import sys

import torch

from . import registry as _registry


def _aslist(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(outs):
    from . import stack

    return [stack(*[o[k] for o in outs], axis=0)
            for k in range(len(outs[0]))]


def foreach(body, data, init_states):
    """Run ``body`` over axis 0 of ``data``.

    body(data_slice, states) -> (outputs, new_states). Returns
    (stacked_outputs, final_states). Reference:
    python/mxnet/ndarray/contrib.py foreach. An unrolled Python loop:
    every op lands on the tape, so gradients reach free variables the
    body captures too."""
    single_data = not isinstance(data, (list, tuple))
    single_state = not isinstance(init_states, (list, tuple))
    data_list = _aslist(data)
    states = _aslist(init_states)
    outs_steps = []
    single_out = True
    for i in range(data_list[0].shape[0]):
        slices = [d[i] for d in data_list]
        out, new_s = body(slices[0] if single_data else slices,
                          states[0] if single_state else list(states))
        outs_steps.append(_aslist(out))
        states = _aslist(new_s)
        single_out = not isinstance(out, (list, tuple))
    stacked = _stack(outs_steps) if outs_steps else []
    outs = stacked[0] if single_out and stacked else stacked
    return outs, (states[0] if single_state else states)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Reference: python/mxnet/ndarray/contrib.py while_loop.
    cond(*loop_vars) -> boolean scalar; func(*loop_vars) -> (step_output,
    new_loop_vars). Returns (stacked_outputs, final_loop_vars): a Python
    loop that reads the condition on the host each step, so it runs the
    actual trip count (the reference's imperative semantics)."""
    from .ndarray import NDArray

    if max_iterations is None:
        raise ValueError("max_iterations is required")
    single = not isinstance(loop_vars, (list, tuple))
    lv = _aslist(loop_vars)
    outs = []
    steps = 0
    while steps < max_iterations:
        c = cond(*lv)
        cval = bool(c.asnumpy().item()) if isinstance(c, NDArray) \
            else bool(c)
        if not cval:
            break
        step_out, new_lv = func(*lv)
        outs.append(_aslist(step_out))
        lv = _aslist(new_lv)
        steps += 1
    stacked = _stack(outs) if outs else []
    return stacked, (lv[0] if single else lv)


def cond(pred, then_func, else_func):
    """Reference: python/mxnet/ndarray/contrib.py cond. then_func and
    else_func take no arguments; the branch is chosen on the host from
    ``pred``."""
    from .ndarray import NDArray

    p = pred._data if isinstance(pred, NDArray) else torch.as_tensor(pred)
    return then_func() if bool(p.reshape(()).to(torch.bool)) else \
        else_func()


def getnnz(data, axis=None):
    """Non-zero count of a dense array (reference: contrib/nnz.cc
    _contrib_getnnz; axis None: total as a (1,) array; else per axis),
    int32. The CSR branch waits for the sparse storage types."""
    from .ndarray import NDArray

    x = data._data if isinstance(data, NDArray) else torch.as_tensor(data)
    if axis is None:
        return NDArray((x != 0).sum().reshape(1).to(torch.int32))
    return NDArray((x != 0).sum(dim=axis).to(torch.int32))


def _public_names():
    return (["foreach", "while_loop", "cond", "reset_arrays", "getnnz"]
            + _CONTRIB_OPS + list(_CONTRIB_ALIASES))


# the JAX package's list (``mxnet_tpu/ndarray/contrib.py:207-217``)
_CONTRIB_OPS = [
    "boolean_mask", "index_copy", "index_array", "adaptive_avg_pooling2d",
    "bilinear_resize2d", "all_finite", "multi_sum_sq",
    "box_iou", "box_nms", "bipartite_matching", "multibox_prior",
    "multibox_target", "multibox_detection", "roi_align",
    "fft", "ifft", "count_sketch", "deformable_convolution",
    "proposal", "multi_proposal", "psroi_pooling",
    "deformable_psroi_pooling", "mrcnn_mask_target",
    "quadratic", "allclose", "div_sqrt_dim", "gradientmultiplier",
    "round_ste", "sign_ste", "reset_arrays", "box_encode", "box_decode",
    "rroi_align", "multi_lars", "hawkesll",
]

# CamelCase contrib aliases (reference registered names)
_CONTRIB_ALIASES = {"MultiBoxPrior": "multibox_prior",
                    "MultiBoxTarget": "multibox_target",
                    "MultiBoxDetection": "multibox_detection",
                    "ROIAlign": "roi_align",
                    "Proposal": "proposal",
                    "MultiProposal": "multi_proposal",
                    "PSROIPooling": "psroi_pooling",
                    "DeformableConvolution": "deformable_convolution",
                    "DeformablePSROIPooling": "deformable_psroi_pooling"}


def _install():
    from . import _make_op_function

    mod = sys.modules[__name__]
    for name in _CONTRIB_OPS:
        od = _registry.get_op(name) or _registry.get_op(name.lower())
        if od is None:
            raise RuntimeError(f"contrib op '{name}' listed but unregistered")
        if not hasattr(mod, name):
            setattr(mod, name, _make_op_function(od))
    for alias, target in _CONTRIB_ALIASES.items():
        setattr(mod, alias, getattr(mod, target))


_install()

_reset_arrays_pure = reset_arrays  # noqa: F821 — installed by _install


def reset_arrays(*arrays, num_arrays=0):  # noqa: F811
    """Zero every input in place (reference contrib/reset_arrays.cc: call
    sites discard the result and read the inputs): each NDArray takes its
    zeroed copy, written into its tensor where it owns one (a
    parameter's or a gradient buffer's, which captured graphs read), else
    rebound."""
    from .ndarray import _owns

    outs = _reset_arrays_pure(*arrays, num_arrays=num_arrays)
    if not isinstance(outs, (list, tuple)):
        outs = (outs,)
    for arr, out in zip(arrays, outs):
        if _owns(arr._data) and arr._data.is_leaf:
            with torch.no_grad():
                arr._data.zero_()
        else:
            arr._data = out._data
    return outs


__all__ = _public_names()
