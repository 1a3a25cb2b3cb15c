"""BaseModule: the symbolic training-loop API.

The PyTorch counterpart of ``mxnet_tpu/module/base_module.py``
(reference: python/mxnet/module/base_module.py; ``fit``:409 — the epoch
loop, metric updates, checkpoint callbacks, evaluation). The
intermediate-level API (forward/backward/update) keeps the reference's
semantics over the bound Executor.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ---- high level ------------------------------------------------------
    def forward_backward(self, data_batch):
        """Reference: base_module.py:193."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0, sparse_row_id_fn=None):
        """Reference: base_module.py score."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric, {}))
        if score_end_callback is not None:
            for cb in _as_list(score_end_callback):
                cb(_BatchEndParam(epoch, nbatch, eval_metric, {}))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """Reference: base_module.py predict."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            # copies: a bound executor's outputs are its own buffers,
            # which the next batch overwrites
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            merged = [nd.concatenate([o[i] for o in output_list])
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The full training loop (reference: base_module.py:409).
        ``eval_metric=None`` skips the metric (and the per-batch copy of
        the outputs to the host it costs)."""
        assert num_epoch is not None, "please specify number of epochs"
        from .. import initializer as init_mod

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params))
        if validation_metric is None:
            validation_metric = eval_metric
        if eval_metric is not None and \
                not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            if eval_metric is not None:
                eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for data_batch in train_data:
                self.forward_backward(data_batch)
                self.update()
                if eval_metric is not None:
                    self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric, {}))
                nbatch += 1
            for name, val in (eval_metric.get_name_value()
                              if eval_metric is not None else ()):
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None and validation_metric is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    # ---- symbol ----------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def install_monitor(self, mon):
        pass

    # abstract interface (reference: base_module.py)
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()


class _BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals_):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals_


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
