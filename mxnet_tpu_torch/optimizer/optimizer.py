"""Optimizer classes.

The PyTorch counterpart of ``mxnet_tpu/optimizer/optimizer.py:25-706,
966-1034`` (reference: python/mxnet/optimizer/optimizer.py): the
``Optimizer`` base with its registry, learning-rate schedules, the
parameters' learning-rate and weight-decay multipliers, per-index update
counts and multi-precision master weights; ``SGD`` (with its
multi-tensor ``update_multi``), ``NAG``, ``Adam``, ``AdaGrad``,
``RMSProp``, ``AdaDelta``, ``Ftrl``, ``SignSGD`` and ``Signum``; and the
``Updater``; and (``mxnet_tpu/optimizer/optimizer.py:593-960``)
``Adamax``, ``Nadam``, ``FTML``, ``LAMB``, ``LARS``, ``LBSGD``,
``DCASGD`` and ``SGLD``. The update arithmetic is in
``ndarray/ops_optim.py``, whose ops write the weight and the state in
place; these classes keep state and hyperparameters, and the last eight
write their own arithmetic into the weight and state tensors in place,
as the JAX ones swap handles. Adam's bias correction is computed on the
host in float64 on the eager path, as the JAX package's eager path does.

The classes of the first group have a ``_fused_kernel``: the update of
a whole list of parameters at once, which the Trainer's fused step
(``gluon/fused_step.py``) runs over a parameter group. The last eight
have none, as in the JAX package, so the Trainer runs them through its
eager per-parameter loop. ``LARS`` and ``LBSGD`` (its ``"lars"``
strategy) read two norms per parameter back to the host, where the JAX
package reads them, so each of their steps waits for the device.
``SGLD`` draws its noise from the device's generator, which never
agrees with the JAX package's threefry stream.

A ``row_sparse`` gradient (the store's sparse push, ``ndarray/sparse.py``)
takes the lazy row update where the JAX package has one: SGD without
momentum when ``lazy_update`` (``sparse.sgd_update_rsp``), Adam when
``lazy_update`` (``sparse.adam_update_rsp``); otherwise it is densified
and takes the dense update, as the JAX optimizers do. The Updater
aggregates a list of dense gradients only.
"""
from __future__ import annotations

import math
import pickle

import numpy as onp
import torch

from ..base import getenv
from ..ndarray import NDArray
from ..ndarray import ops_optim as _oo
from ..ndarray import sparse as _sp

__all__ = ["Optimizer", "register", "create", "SGD", "NAG", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "SignSGD", "Signum",
           "Adamax", "Nadam", "FTML", "LAMB", "LARS", "LBSGD", "DCASGD",
           "SGLD", "Updater", "get_updater"]

_REGISTRY = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer from an instance or a registered name."""
    if isinstance(name, Optimizer):
        return name
    try:
        klass = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"optimizer {name!r} not registered; known: "
                         f"{sorted(_REGISTRY)}") from None
    return klass(**kwargs)


def _zeros_like(weight):
    return NDArray(torch.zeros_like(weight.data, requires_grad=False))


class Optimizer:
    """Base optimizer (reference: optimizer.py:143)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}  # index -> gluon Parameter

    create_optimizer = staticmethod(create)

    def create_state(self, index, weight):
        return None

    @staticmethod
    def _is_half(weight):
        # the reference gates on float16 (optimizer.py:232); bfloat16
        # needs the same float32 master
        return weight.data.dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        """A half-precision weight gets a float32 master copy, and its
        state is built on the master (reference: optimizer.py:232)."""
        if self.multi_precision and self._is_half(weight):
            master = NDArray(weight.data.detach().to(torch.float32))
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """The update on the float32 master of a half weight, written back
        as its cast; a plain update otherwise."""
        if self.multi_precision and self._is_half(weight):
            master, base_state = state
            g32 = grad.astype("float32") if isinstance(
                grad, _sp.BaseSparseNDArray) else \
                NDArray(grad.data.to(torch.float32))
            self.update(index, master, g32, base_state)
            with torch.no_grad():
                weight.data.copy_(master.data)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _lr_mult_of(self, index):
        if index in self.param_dict:
            return self.param_dict[index].lr_mult
        if index in self.lr_mult:
            return self.lr_mult[index]
        if index in self.idx2name:
            return self.lr_mult.get(self.idx2name[index], 1.0)
        return 1.0

    def _wd_mult_of(self, index):
        if index in self.param_dict:
            return self.param_dict[index].wd_mult
        if index in self.wd_mult:
            return self.wd_mult[index]
        if index in self.idx2name:
            return self.wd_mult.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.learning_rate * self._lr_mult_of(index)

    def _get_wd(self, index):
        return self.wd * self._wd_mult_of(index)

    def _sparse_kwargs(self):
        """The rescale and the clip as the lazy row updates take them
        (None: no clip)."""
        return {"rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient}

    def _clip(self):
        """clip_gradient as the ops take it: a value <= 0 disables it."""
        return -1.0 if self.clip_gradient is None else \
            float(self.clip_gradient)

    def _fused_kernel(self):
        """The update over a list of parameters for the Trainer's fused
        step (``gluon/fused_step.py``): ``(static_key, fn)`` with
        ``fn(ws, gs, ss, lr, wd, rescale, t) -> (new_ws, new_ss)`` over
        lists of tensors (``ss`` the parameters' states: None, a tensor
        or a tuple of them), returning new tensors and writing nothing.
        ``lr``, ``wd`` and ``rescale`` are 0-d float32 tensors on the
        device, shared by the list, and ``t`` the 0-d int32 update count
        after this step, so ``set_learning_rate`` and the loss scale
        never change the function. The closure captures static
        hyperparameters only (momentum, betas, clip), and ``static_key``
        keys the fused step's cache. None (the default): no fused path,
        and the Trainer runs the eager per-parameter loop."""
        return None

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _data(xs):
    return [x.data for x in xs]


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py:601). A list of indices
    given to the Updater updates through the multi-tensor ops, in chunks
    of ``aggregate_num`` (``MXNET_OPTIMIZER_AGGREGATION_SIZE``, default
    4)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self.aggregate_num = getenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", 4,
                                    int)

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if isinstance(grad, _sp.RowSparseNDArray):
            # the stored rows alone (reference: SGDUpdateRspImpl);
            # momentum densifies, as the reference's std_update path does
            if state is None and self.lazy_update:
                _sp.sgd_update_rsp(weight, grad, lr=lr, wd=wd,
                                   **self._sparse_kwargs())
                return
            grad = grad.todense()
        if state is None:
            _oo.sgd_update(weight.data, grad.data, lr, wd=wd,
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self._clip())
        else:
            _oo.sgd_mom_update(weight.data, grad.data, state.data, lr,
                               momentum=self.momentum, wd=wd,
                               rescale_grad=self.rescale_grad,
                               clip_gradient=self._clip())

    def update_multi(self, indices, weights, grads, states):
        """Aggregated update through the multi-tensor ops, chunked by
        ``aggregate_num`` (reference: optimizer.py _update_impl with
        aggregate=True -> MultiSGD(Mom)Update / MultiMPSGD(Mom)Update)."""
        agg = max(1, int(self.aggregate_num))
        kw = {"rescale_grad": self.rescale_grad,
              "clip_gradient": self._clip()}
        mom = self.momentum
        for i0 in range(0, len(indices), agg):
            idxs = indices[i0:i0 + agg]
            ws, gs = weights[i0:i0 + agg], grads[i0:i0 + agg]
            sts = states[i0:i0 + agg]
            n = len(idxs)
            halfs = [self.multi_precision and self._is_half(w) for w in ws]
            mp = all(halfs)
            if any(halfs) and not mp:
                # a mixed chunk: the per-tensor path keeps the state
                # layouts apart (it counts its own updates)
                for i, w, g, s in zip(idxs, ws, gs, sts):
                    self.update_multi_precision(i, w, g, s)
                continue
            for i in idxs:
                self._update_count(i)
            lrs = [self._get_lr(i) for i in idxs]
            wds = [self._get_wd(i) for i in idxs]
            if mp:
                masters = [s[0] for s in sts]
                base = [s[1] for s in sts]
                if mom:
                    ins = [x for w, g, s, m32 in zip(ws, gs, base, masters)
                           for x in (w, g, s, m32)]
                    _oo.multi_mp_sgd_mom_update(
                        *_data(ins), lrs=lrs, wds=wds, momentum=mom,
                        num_weights=n, **kw)
                else:
                    ins = [x for w, g, m32 in zip(ws, gs, masters)
                           for x in (w, g, m32)]
                    _oo.multi_mp_sgd_update(*_data(ins), lrs=lrs, wds=wds,
                                            num_weights=n, **kw)
            elif mom:
                ins = [x for w, g, s in zip(ws, gs, sts) for x in (w, g, s)]
                _oo.multi_sgd_mom_update(*_data(ins), lrs=lrs, wds=wds,
                                         momentum=mom, num_weights=n, **kw)
            else:
                ins = [x for w, g in zip(ws, gs) for x in (w, g)]
                _oo.multi_sgd_update(*_data(ins), lrs=lrs, wds=wds,
                                     num_weights=n, **kw)

    def _fused_kernel(self):
        if type(self).update is not SGD.update:
            return None  # a subclass with its own arithmetic: eager
        clip, mom = self._clip(), float(self.momentum)
        if mom:
            def fn(ws, gs, ss, lr, wd, rescale, t):
                return _oo.sgd_mom_lists(ws, gs, ss, lr, mom, wd, rescale,
                                         clip)
        else:
            def fn(ws, gs, ss, lr, wd, rescale, t):
                return _oo.sgd_lists(ws, gs, lr, wd, rescale, clip), ss
        return ("sgd", mom, clip), fn


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: optimizer.py NAG)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = {"wd": wd, "rescale_grad": self.rescale_grad,
              "clip_gradient": self._clip()}
        if state is None:
            _oo.sgd_update(weight.data, grad.data, lr, **kw)
        else:
            _oo.nag_mom_update(weight.data, grad.data, state.data, lr,
                               momentum=self.momentum, **kw)

    def _fused_kernel(self):
        if type(self).update is not NAG.update:
            return None
        clip, mom = self._clip(), float(self.momentum)
        if mom:
            def fn(ws, gs, ss, lr, wd, rescale, t):
                return _oo.nag_mom_lists(ws, gs, ss, lr, mom, wd, rescale,
                                         clip)
        else:
            def fn(ws, gs, ss, lr, wd, rescale, t):
                return _oo.sgd_lists(ws, gs, lr, wd, rescale, clip), ss
        return ("nag", mom, clip), fn


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        # bias correction on the host in float64 (optimizer.py:361)
        lr *= (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
        if isinstance(grad, _sp.RowSparseNDArray):
            if self.lazy_update:  # reference: AdamUpdateRspImpl
                _sp.adam_update_rsp(weight, grad, mean, var, lr=lr,
                                    beta1=self.beta1, beta2=self.beta2,
                                    epsilon=self.epsilon, wd=wd,
                                    **self._sparse_kwargs())
                return
            grad = grad.todense()
        _oo.adam_update(weight.data, grad.data, mean.data, var.data, lr,
                        beta1=self.beta1, beta2=self.beta2,
                        epsilon=self.epsilon, wd=wd,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self._clip())

    def _fused_kernel(self):
        if type(self).update is not Adam.update:
            return None
        b1, b2 = float(self.beta1), float(self.beta2)
        eps, clip = float(self.epsilon), self._clip()

        def fn(ws, gs, ss, lr, wd, rescale, t):
            # the bias correction from the device count, in float32 (the
            # eager path's is float64 on the host: ulps apart)
            tf = t.to(torch.float32)
            coef = torch.sqrt(1.0 - b2 ** tf) / (1.0 - b1 ** tf)
            ws2, ms2, vs2 = _oo.adam_lists(
                ws, gs, [s[0] for s in ss], [s[1] for s in ss], lr * coef,
                b1, b2, eps, wd, rescale, clip)
            return ws2, list(zip(ms2, vs2))
        return ("adam", b1, b2, eps, clip), fn


def _per_tensor(math):
    """A fused kernel from a per-tensor update ``math(w, g, s, lr, wd,
    rescale) -> (w2, s2)``: the list is updated tensor by tensor (one
    captured graph replays them all on the card)."""
    def fn(ws, gs, ss, lr, wd, rescale, t):
        new_w, new_s = [], []
        for w, g, s in zip(ws, gs, ss):
            w2, s2 = math(w, g, s, lr, wd, rescale)
            new_w.append(w2)
            new_s.append(s2)
        return new_w, new_s
    return fn


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py AdaGrad): eps inside the square
    root, and a set ``clip_gradient`` clips even when <= 0."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w2, h2 = _oo.adagrad_math(weight.data, grad.data, state.data, lr,
                                  self.float_stable_eps, wd,
                                  self.rescale_grad, self.clip_gradient)
        _oo._commit([weight.data, state.data], [w2, h2])

    def _fused_kernel(self):
        if type(self).update is not AdaGrad.update:
            return None
        eps = float(self.float_stable_eps)
        clip = None if self.clip_gradient is None else \
            float(self.clip_gradient)
        return ("adagrad", eps, clip), _per_tensor(
            lambda w, g, s, lr, wd, rescale: _oo.adagrad_math(
                w, g, s, lr, eps, wd, rescale, clip))


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centered (reference: optimizer.py RMSProp)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return _zeros_like(weight)

    def _clip_weights(self):
        return -1.0 if not self.clip_weights else float(self.clip_weights)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = {"epsilon": self.epsilon, "wd": wd,
              "rescale_grad": self.rescale_grad,
              "clip_gradient": self._clip(),
              "clip_weights": self._clip_weights()}
        if not self.centered:
            _oo.rmsprop_update(weight.data, grad.data, state.data, lr,
                               gamma1=self.gamma1, **kw)
        else:
            n, g, delta = state
            _oo.rmspropalex_update(weight.data, grad.data, n.data, g.data,
                                   delta.data, lr, gamma1=self.gamma1,
                                   gamma2=self.gamma2, **kw)

    def _fused_kernel(self):
        if type(self).update is not RMSProp.update:
            return None
        g1, g2 = float(self.gamma1), float(self.gamma2)
        eps, clip, clipw = float(self.epsilon), self._clip(), \
            self._clip_weights()
        key = ("rmsprop", g1, g2, eps, clip, clipw, bool(self.centered))
        if self.centered:
            def math(w, g, s, lr, wd, rescale):
                w2, *s2 = _oo.rmspropalex_math(w, g, *s, lr, g1, g2, eps, wd,
                                               rescale, clip, clipw)
                return w2, tuple(s2)
        else:
            def math(w, g, s, lr, wd, rescale):
                return _oo.rmsprop_math(w, g, s, lr, g1, eps, wd, rescale,
                                        clip, clipw)
        return key, _per_tensor(math)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta); no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_d = state
        new = _oo.adadelta_math(weight.data, grad.data, acc_g.data,
                                acc_d.data, self.rho, self.epsilon, wd,
                                self.rescale_grad, self.clip_gradient)
        _oo._commit([weight.data, acc_g.data, acc_d.data], new)

    def _fused_kernel(self):
        if type(self).update is not AdaDelta.update:
            return None
        rho, eps = float(self.rho), float(self.epsilon)
        clip = None if self.clip_gradient is None else \
            float(self.clip_gradient)

        def math(w, g, s, lr, wd, rescale):  # lr unused, as eager
            w2, a2, d2 = _oo.adadelta_math(w, g, s[0], s[1], rho, eps, wd,
                                           rescale, clip)
            return w2, (a2, d2)
        return ("adadelta", rho, eps, clip), _per_tensor(math)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py Ftrl)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        _oo.ftrl_update(weight.data, grad.data, z.data, n.data, lr,
                        lamda1=self.lamda1, beta=self.beta, wd=wd,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self._clip())

    def _fused_kernel(self):
        if type(self).update is not Ftrl.update:
            return None
        lamda1, beta, clip = float(self.lamda1), float(self.beta), \
            self._clip()

        def math(w, g, s, lr, wd, rescale):
            w2, z2, n2 = _oo.ftrl_math(w, g, s[0], s[1], lr, lamda1, beta,
                                       wd, rescale, clip)
            return w2, (z2, n2)
        return ("ftrl", lamda1, beta, clip), _per_tensor(math)


@register
class SignSGD(Optimizer):
    """signSGD (reference: optimizer.py SignSGD)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _oo.signsgd_update(weight.data, grad.data, self._get_lr(index),
                           wd=self._get_wd(index),
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self._clip())

    def _fused_kernel(self):
        if type(self).update is not SignSGD.update:
            return None
        clip = self._clip()

        def fn(ws, gs, ss, lr, wd, rescale, t):
            return _oo.signsgd_lists(ws, gs, lr, wd, rescale, clip), ss
        return ("signsgd", clip), fn


@register
class Signum(Optimizer):
    """Signum, momentum then sign (reference: optimizer.py Signum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = {"wd": wd, "rescale_grad": self.rescale_grad,
              "clip_gradient": self._clip()}
        if state is None:
            _oo.signsgd_update(weight.data, grad.data, lr, **kw)
        else:
            _oo.signum_update(weight.data, grad.data, state.data, lr,
                              momentum=self.momentum, wd_lh=self.wd_lh, **kw)

    def _fused_kernel(self):
        if type(self).update is not Signum.update:
            return None
        mom, wd_lh, clip = float(self.momentum), float(self.wd_lh), \
            self._clip()
        if mom:
            def fn(ws, gs, ss, lr, wd, rescale, t):
                return _oo.signum_lists(ws, gs, ss, lr, mom, wd, rescale,
                                        clip, wd_lh)
        else:
            def fn(ws, gs, ss, lr, wd, rescale, t):
                return _oo.signsgd_lists(ws, gs, lr, wd, rescale, clip), ss
        return ("signum", mom, wd_lh, clip), fn


# -- the optimizers without a fused kernel (the Trainer's eager loop) ------

def _clipped(self, grad):
    """``grad * rescale_grad``, clipped when ``clip_gradient`` is set,
    as the JAX optimizers of this group do it (a set value clips even
    when it is not positive)."""
    g = grad * self.rescale_grad
    if self.clip_gradient is not None:
        c = float(self.clip_gradient)
        g = torch.clamp(g, -c, c)
    return g


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm (reference: optimizer.py
    Adamax)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        w = weight.data
        with torch.no_grad():
            g = grad.data * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                c = float(self.clip_gradient)
                g = torch.clamp(g, -c, c)
            m, u = state[0].data, state[1].data
            m2 = self.beta1 * m + (1.0 - self.beta1) * g
            u2 = torch.maximum(self.beta2 * u, torch.abs(g))
            w2 = w - lr * m2 / (u2 + 1e-8)
        _oo._commit([w, m, u], [w2, m2, u2])


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and Dozat's momentum schedule
    (reference: optimizer.py Nadam). ``m_schedule`` is one product for
    the whole optimizer, advanced by every parameter's update, as in the
    reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        b1, b2 = self.beta1, self.beta2
        momentum_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = b1 * (1.0 - 0.5 * 0.96 **
                             ((t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        w = weight.data
        with torch.no_grad():
            g = grad.data * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                c = float(self.clip_gradient)
                g = torch.clamp(g, -c, c)
            m, v = state[0].data, state[1].data
            m2 = b1 * m + (1.0 - b1) * g
            v2 = b2 * v + (1.0 - b2) * g * g
            g_prime = g / (1.0 - self.m_schedule)
            m_prime = m2 / (1.0 - m_schedule_next)
            v_prime = v2 / (1.0 - b2 ** t)
            m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
            w2 = w - lr * m_bar / (v_prime ** 0.5 + self.epsilon)
        _oo._commit([w, m, v], [w2, m2, v2])


@register
class FTML(Optimizer):
    """Follow the Moving Leader (Zheng and Kwok 2017; reference:
    optimizer.py FTML) over the ``ftml_update`` op."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        d, v, z = state
        _oo.ftml_update(weight.data, grad.data, d.data, v.data, z.data,
                        self._get_lr(index), beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon,
                        wd=self._get_wd(index),
                        rescale_grad=self.rescale_grad,
                        clip_grad=self._clip(), t=t)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (You et al. 2019; reference:
    optimizer.py LAMB) over ``lamb_update_phase1``, two norms on the
    device and ``lamb_update_phase2``: nothing is read back."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        w = weight.data
        g, _, _ = _oo.lamb_update_phase1(
            w, grad.data, mean.data, var.data, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, t=t,
            bias_correction=self.bias_correction, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad, clip_gradient=self._clip())
        with torch.no_grad():
            r1 = torch.linalg.vector_norm(w)
            r2 = torch.linalg.vector_norm(g)
        _oo.lamb_update_phase2(w, g, r1, r2, self._get_lr(index),
                               lower_bound=self.lower_bound or -1.0,
                               upper_bound=self.upper_bound or -1.0)


def _sgd_step(weight, g, state, lr, momentum, wd):
    """The SGD(-momentum) step on an already rescaled and clipped
    gradient, in place."""
    if state is None:
        _oo.sgd_update(weight.data, g, lr, wd=wd)
    else:
        _oo.sgd_mom_update(weight.data, g, state.data, lr,
                           momentum=momentum, wd=wd)


def _host_norm(t):
    """A tensor's 2-norm read back to the host (a device sync)."""
    return float(torch.linalg.vector_norm(t))


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling SGD (You et al. 2017, "Large
    Batch Training of Convolutional Networks"; reference: optimizer.py
    LARS): a parameter's rate is ``lr * eta * |w| / (|g| + wd * |w| +
    eps)`` when both norms are positive. Biases and batch-norm
    parameters (by name) keep the plain rate. The two norms are read on
    the host, as the JAX optimizer reads them."""

    def __init__(self, momentum=0.0, lazy_update=True, eta=0.001, eps=0,
                 momentum_correction=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self.eta = eta
        self.eps = eps
        self.momentum_correction = momentum_correction
        self.last_lr = None
        self.cur_lr = None

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _is_scaled(self, index):
        name = self.idx2name.get(index, str(index))
        return not (name.endswith("_bias") or name.endswith("_gamma")
                    or name.endswith("_beta")
                    or "batchnorm" in name.lower())

    @staticmethod
    def lars_scale(w_norm, g_norm, wd, eta, eps):
        """The layer-wise multiplier of the rate (LBSGD's ``"lars"``
        strategy uses it too)."""
        if w_norm > 0 and g_norm > 0:
            return eta * w_norm / (g_norm + wd * w_norm + eps)
        return 1.0

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        # the momentum correction follows the schedule's base rate across
        # steps, not the per-parameter rate
        base_lr = self.learning_rate
        if base_lr != self.cur_lr:
            self.last_lr, self.cur_lr = self.cur_lr, base_lr
        momentum = self.momentum
        if self.momentum_correction and self.last_lr not in (None, 0):
            momentum = self.momentum * self.cur_lr / self.last_lr
        with torch.no_grad():
            g = _clipped(self, grad.data)
        if self._is_scaled(index):
            lr = lr * self.lars_scale(_host_norm(weight.data), _host_norm(g),
                                      wd, self.eta, self.eps)
        _sgd_step(weight, g, state, lr, momentum, wd)


@register
class LBSGD(Optimizer):
    """Large-batch SGD with a warm-up (reference: optimizer.py LBSGD):
    momentum SGD whose rate follows ``warmup_strategy`` ("linear",
    "power2" or "sqrt") over ``warmup_epochs``, or is LARS-scaled
    ("lars", two host reads per parameter, as in the JAX package)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = max(1, updates_per_epoch)
        self.init_updates = begin_epoch * self.updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _warmup_mult(self):
        nup = self.num_update + self.init_updates + 1
        total_warm = self.warmup_epochs * self.updates_per_epoch
        if nup >= total_warm:
            return float(self.batch_scale)
        frac = nup / total_warm
        if self.warmup_strategy == "power2":
            mult = self.batch_scale * frac * frac
        elif self.warmup_strategy == "sqrt":
            mult = self.batch_scale * (frac ** 0.5)
        else:
            mult = 1.0 + frac * (self.batch_scale - 1)
        return float(max(mult, 1.0))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = _clipped(self, grad.data)
        if self.warmup_strategy == "lars":
            lr = lr * LARS.lars_scale(_host_norm(weight.data), _host_norm(g),
                                      wd, eta=0.001, eps=1e-9)
        else:
            lr = lr * self._warmup_mult() / max(self.batch_scale, 1)
        _sgd_step(weight, g, state, lr, self.momentum, wd)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (Zheng et al. 2017; reference:
    optimizer.py DCASGD): the gradient corrected by ``lamda * g * g *
    (w - w_prev)``; the state holds the momentum (or None) and the
    previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, NDArray(weight.data.detach().clone()))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, prev = state
        w = weight.data
        with torch.no_grad():
            g = _clipped(self, grad.data)
            comp = g + wd * w + self.lamda * g * g * (w - prev.data)
            if mom is not None:
                step = self.momentum * mom.data - lr * comp
                mom.data.copy_(step)
            else:
                step = -lr * comp
            prev.data.copy_(w)
            w.add_(step)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (Welling and Teh 2011;
    reference: optimizer.py SGLD): ``w - lr/2 * (g + wd * w)`` plus
    N(0, lr) noise from the device's generator: a sampler of the
    posterior rather than an optimizer."""

    def _noise(self, weight, lr):
        from .. import random as _random
        from ..context import Context

        return _random.normal(0, math.sqrt(lr), shape=weight.shape,
                              dtype=str(weight.data.dtype).replace(
                                  "torch.", ""),
                              ctx=Context.from_device(weight.data.device))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight.data
        noise = self._noise(weight, lr)
        with torch.no_grad():
            g = _clipped(self, grad.data)
            w2 = w - (lr / 2) * (g + wd * w)
            if noise is not None:
                w2 = w2 + noise.data
        _oo._commit([w], [w2])


class Updater:
    """The kvstore updater closure (reference: optimizer.py:1943): keeps
    one state per index, built with ``create_state_multi_precision``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        # reference optimizer.py:1954: aggregation is on when the
        # optimizer has a multi-tensor path
        self.aggregate_updates = (
            getattr(optimizer, "aggregate_num", 0) >= 1 and
            hasattr(optimizer, "update_multi"))

    def __call__(self, index, grad, weight):
        """One index, or lists of (index, grad, weight) as in the
        reference, aggregated through the optimizer's multi-tensor path
        when it has one."""
        if isinstance(index, (list, tuple)):
            indices, grads, weights = list(index), list(grad), list(weight)
        else:
            indices, grads, weights = [index], [grad], [weight]
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
                self.states_synced[i] = True
        dense = not any(isinstance(g, _sp.BaseSparseNDArray) for g in grads)
        if len(indices) > 1 and dense and self.aggregate_updates:
            self.optimizer.update_multi(indices, weights, grads,
                                        [self.states[i] for i in indices])
        else:
            for i, g, w in zip(indices, grads, weights):
                self.optimizer.update_multi_precision(i, w, g,
                                                      self.states[i])

    def get_states(self, dump_optimizer=False):
        """The states as pickled bytes (host arrays)."""
        def host(v):
            if isinstance(v, NDArray):
                return v.asnumpy()
            if isinstance(v, tuple):
                return tuple(host(s) for s in v)
            return v

        states = {k: host(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)

    def set_states(self, states):
        """Restore what :meth:`get_states` returned (bytes this program
        wrote: they are unpickled)."""
        from ..ndarray import array

        obj = pickle.loads(states)
        if isinstance(obj, tuple) and len(obj) == 2 and \
                isinstance(obj[1], Optimizer):
            states, self.optimizer = obj
        else:
            states = obj

        def restore(v):
            if isinstance(v, tuple):
                return tuple(restore(s) for s in v)
            if isinstance(v, onp.ndarray):
                return array(v)
            return v

        self.states = {k: restore(v) for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}


def get_updater(optimizer):
    return Updater(optimizer)
