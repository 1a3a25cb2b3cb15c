"""Chain-of-modules container; the PyTorch counterpart of
``mxnet_tpu/module/sequential_module.py`` (reference:
python/mxnet/module/sequential_module.py — SequentialModule chains
bound modules so data flows module-to-module and gradients flow back
through ``get_input_grads``)."""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """Run several modules as one pipeline: module i+1 consumes module
    i's outputs as its data. Meta flags per added module:

    - ``take_labels``: this module also receives the batch labels
      (any module in the chain may; they all see the same labels).
    - ``auto_wiring``: rename the previous module's outputs to this
      module's data names positionally.
    """

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._chain = []   # (module, meta) pairs
        self._data_shapes = None
        self._label_shapes = None

    def add(self, module, **meta):
        known = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        for k in meta:
            if k not in known:
                raise ValueError(f'unknown meta "{k}", a typo?')
        self._chain.append((module, meta))
        # structure changed: every lifecycle stage must rerun
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self  # chainable

    # ---- introspection ---------------------------------------------------
    @property
    def data_names(self):
        return self._chain[0][0].data_names if self._chain else []

    @property
    def output_names(self):
        return self._chain[-1][0].output_names if self._chain else []

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._chain[-1][0].output_shapes

    @property
    def label_names(self):
        for module, meta in self._chain:
            if meta.get(self.META_TAKE_LABELS):
                return module.label_names
        return []

    # ---- lifecycle -------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        assert self._chain, "add() modules before bind()"
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc)
                              else DataDesc(*d)
                              for d in (label_shapes or [])]
        cur = self._data_shapes
        for i, (module, meta) in enumerate(self._chain):
            if meta.get(self.META_AUTO_WIRING):
                cur = [DataDesc(name, d.shape, d.dtype) for name, d in
                       zip(module.data_names, cur)]
            labels = self._label_shapes \
                if meta.get(self.META_TAKE_LABELS) else None
            # inner modules need input grads so backward chains through
            module.bind(cur, label_shapes=labels,
                        for_training=for_training,
                        inputs_need_grad=for_training and i > 0,
                        force_rebind=force_rebind, grad_req=grad_req)
            cur = [DataDesc(name, shape) for name, shape in
                   module.output_shapes]
        self.binded = True
        self.for_training = for_training

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        assert self.binded
        for module, _ in self._chain:
            # each child owns a SUBSET of the combined param dict, so
            # extras (other children's params) are always allowed — but
            # the caller's allow_missing strictness passes through: a
            # truncated checkpoint must fail, not silently re-init
            module.init_params(initializer=initializer,
                               arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init,
                               allow_extra=True)
        self.params_initialized = True

    def get_params(self):
        args, auxs = {}, {}
        for module, _ in self._chain:
            a, x = module.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for module, _ in self._chain:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # ---- compute ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for module, meta in self._chain:
            labels = data_batch.label \
                if meta.get(self.META_TAKE_LABELS) else None
            module.forward(DataBatch(data=batch.data, label=labels),
                           is_train=is_train)
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        grads = out_grads
        for i in range(len(self._chain) - 1, -1, -1):
            module, _ = self._chain[i]
            module.backward(out_grads=grads)
            if i > 0:
                grads = module.get_input_grads()

    def update(self):
        assert self.optimizer_initialized
        for module, _ in self._chain:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._chain[-1][0].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._chain[0][0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for module, meta in self._chain:
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels, pre_sliced)
