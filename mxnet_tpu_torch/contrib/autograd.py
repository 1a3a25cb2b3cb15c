"""The legacy experimental autograd API (``mx.contrib.autograd``;
reference: python/mxnet/contrib/autograd.py, the surface scripts written
before ``mx.autograd`` import). The PyTorch counterpart of
``mxnet_tpu/contrib/autograd.py``: thin adapters over
:mod:`mxnet_tpu_torch.autograd`."""
from __future__ import annotations

import functools

from .. import autograd as _ag
from ..ndarray import NDArray

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad"]


def set_is_training(is_train):
    """Turn recording and training on or off; returns the previous
    recording state (reference contrib/autograd.py:32)."""
    prev = _ag.is_recording()
    _ag.set_recording(bool(is_train))
    _ag.set_training(bool(is_train))
    return prev


class TrainingStateScope:
    """Recording and training set to one state inside the scope
    (reference contrib/autograd.py:54)."""

    def __init__(self, enter_state):
        self._enter_state = bool(enter_state)
        self._prev_r = None
        self._prev_t = None

    def __enter__(self):
        self._prev_r = _ag.set_recording(self._enter_state)
        self._prev_t = _ag.set_training(self._enter_state)

    def __exit__(self, *exc):
        _ag.set_recording(self._prev_r)
        _ag.set_training(self._prev_t)


def train_section():
    """``with autograd.train_section():`` the legacy recording scope."""
    return TrainingStateScope(True)


def test_section():
    """``with autograd.test_section():`` recording and training off."""
    return TrainingStateScope(False)


def mark_variables(variables, gradients, grad_reqs="write"):
    _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    _ag.backward(outputs, out_grads, retain_graph=retain_graph)


def compute_gradient(outputs):
    """Backward from ``outputs`` with head gradients of ones (reference
    contrib/autograd.py:158)."""
    _ag.backward(outputs)


def grad_and_loss(func, argnum=None):
    """Decorator: ``f(*args)`` returns ``(gradients, outputs)``, the
    gradients of the NDArray arguments ``argnum`` (all by default)
    (reference contrib/autograd.py:163)."""

    @functools.wraps(func)
    def wrapped(*args):
        from .. import ndarray as nd

        variables = list(args)
        if argnum is not None:
            nums = [argnum] if isinstance(argnum, int) else list(argnum)
            variables = [args[i] for i in nums]
        for v in variables:
            if not isinstance(v, NDArray):
                raise TypeError("arguments must be NDArrays")
        # fresh zero buffers every call, as the reference: a reused one
        # would carry a grad_req="add" sum or a stale value into the next
        _ag.mark_variables(
            variables, [nd.zeros(v.shape, dtype=v.dtype, ctx=v.context)
                        for v in variables])
        with TrainingStateScope(True):
            outputs = func(*args)
        _ag.backward([outputs] if isinstance(outputs, NDArray)
                     else list(outputs))
        grads = [v.grad for v in variables]
        return grads, outputs

    return wrapped


def grad(func, argnum=None):
    """Decorator returning only the gradients (reference
    contrib/autograd.py:195)."""
    g_and_l = grad_and_loss(func, argnum)

    @functools.wraps(func)
    def wrapped(*args):
        return g_and_l(*args)[0]

    return wrapped
