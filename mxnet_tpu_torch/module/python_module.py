"""Pure-Python modules; the PyTorch counterpart of
``mxnet_tpu/module/python_module.py`` (reference:
python/mxnet/module/python_module.py
— PythonModule stubs the Module lifecycle for parameter-less python
computation; PythonLossModule turns a python-computed gradient into a
chain head, e.g. a custom loss at the top of a SequentialModule)."""
from __future__ import annotations

import logging

import numpy as onp

from .. import ndarray as nd
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Lifecycle no-ops for modules computed in Python with no
    parameters: subclasses implement ``forward`` (and ``backward`` when
    trainable) only."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # ---- parameter lifecycle: nothing to do ------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_names:
            eval_metric.update_dict(
                dict(zip(self._label_names, labels or [])),
                dict(zip(self._output_names, self.get_outputs())))

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc)
                              else DataDesc(*d)
                              for d in (label_shapes or [])]
        self._output_shapes = self._compute_output_shapes()
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def _compute_output_shapes(self):
        """Default: one output mirroring the first data shape; override
        for anything richer (reference PythonModule leaves this to the
        subclass too)."""
        return [(self._output_names[0], tuple(self._data_shapes[0].shape))]


class PythonLossModule(PythonModule):
    """A chain-head loss computed in Python: forward stores the scores,
    ``get_input_grads`` serves a python-provided gradient function
    (default: identity pass-through of the stored gradient, matching
    the reference's grad_func hook)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        # labels track THIS batch: clearing on unlabeled batches keeps
        # backward from silently differentiating a previous batch
        self._labels = data_batch.label[0] if data_batch.label else None

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "pyloss is a chain head"
        if self._labels is None:
            raise ValueError(
                "PythonLossModule.backward needs labels: forward ran "
                "without them — add it to the chain with "
                "take_labels=True (or feed batch labels)")
        if self._grad_func is not None:
            g = self._grad_func(self._scores, self._labels)
            self._scores_grad = g if isinstance(g, nd.NDArray) \
                else nd.array(onp.asarray(g), ctx=self._scores.context)
        else:
            # default: cross-entropy-style (softmax(scores) - onehot)
            s = self._scores.asnumpy()
            e = onp.exp(s - s.max(axis=-1, keepdims=True))
            p = e / e.sum(axis=-1, keepdims=True)
            lab = self._labels.asnumpy().astype(int)
            p[onp.arange(p.shape[0]), lab] -= 1.0
            self._scores_grad = nd.array(p, ctx=self._scores.context)

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        pass
