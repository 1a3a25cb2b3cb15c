"""Gluon Trainer: one card, an eager in-place update per parameter.

The PyTorch counterpart of ``mxnet_tpu/gluon/trainer.py:33-100,593-700``
(reference: python/mxnet/gluon/trainer.py). ``step(batch_size)``
rescales the gradients by ``1/batch_size`` and runs the optimizer's
update for every parameter whose ``grad_req`` is not ``"null"``; the
update writes the parameter's own tensor in place, so the blocks that
registered it see the new values.

Single device: ``kvstore`` ``"device"`` or ``"local"`` (or None) is
accepted and does nothing; a ``dist*`` kvstore raises. The JAX
package's compiled fused step, the AMP loss scaler and the asynchronous
gradient all-reduce are not ported yet (ROADMAP).
"""
from __future__ import annotations

import pickle

import numpy as onp
import torch

from ..base import MXNetError
from .. import optimizer as opt
from ..ndarray import NDArray
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    gluon/trainer.py Trainer)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if hasattr(params, "values"):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(p)}.")
        if isinstance(kvstore, str) and kvstore.startswith("dist"):
            raise MXNetError(f"kvstore {kvstore!r}: distributed training is "
                             "not ported yet (the multi-device slice)")
        if kvstore not in (None, "device", "local"):
            raise MXNetError(f"unknown kvstore {kvstore!r} (expected "
                             "'device' or 'local')")
        self._params = list(params)
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an instance of Optimizer instead of str")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._states = None

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _create_states(self):
        self._states = [self._optimizer.create_state(i, p.data())
                        for i, p in enumerate(self._params)]

    def step(self, batch_size):
        """Update every parameter from its gradient, rescaled by
        ``1/batch_size`` (reference: trainer.py step)."""
        self.update(batch_size)

    def update(self, batch_size):
        """Reference: trainer.py update (no gradient all-reduce: one
        card)."""
        if self._states is None:
            self._create_states()
        self._optimizer.rescale_grad = self._scale / batch_size
        try:
            for i, p in enumerate(self._params):
                if p.grad_req == "null":
                    continue
                self._optimizer.update(i, p.data(), p.grad(), self._states[i])
        finally:
            self._optimizer.rescale_grad = self._scale

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    def save_states(self, fname):
        """Write the optimizer's state (moments, update counts) to
        ``fname`` (reference: trainer.py save_states)."""
        if self._states is None:
            self._create_states()
        opt_ = self._optimizer
        payload = {"num_update": opt_.num_update,
                   "index_update_count": dict(opt_._index_update_count),
                   "states": [_dump(s) for s in self._states]}
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def load_states(self, fname):
        """Restore what :meth:`save_states` wrote, onto each parameter's
        device (reference: trainer.py load_states)."""
        with open(fname, "rb") as f:
            payload = pickle.load(f)  # a file this trainer wrote
        if len(payload["states"]) != len(self._params):
            raise MXNetError(f"{fname}: states for {len(payload['states'])} "
                             f"parameters, the trainer has "
                             f"{len(self._params)}")
        self._states = [_load(s, p.data().data.device)
                        for s, p in zip(payload["states"], self._params)]
        opt_ = self._optimizer
        opt_.num_update = opt_.begin_num_update = payload["num_update"]
        opt_._index_update_count = dict(payload["index_update_count"])


def _dump(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_dump(s) for s in state)
    return state.asnumpy()


def _load(state, device):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_load(s, device) for s in state)
    return NDArray(torch.from_numpy(onp.array(state)).to(device))
