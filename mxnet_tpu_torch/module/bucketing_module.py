"""BucketingModule: one executor per bucket, sharing parameters.

The PyTorch counterpart of ``mxnet_tpu/module/bucketing_module.py``
(reference: python/mxnet/module/bucketing_module.py:40-79). Each bucket
key gets its own Module, whose executor captures its own CUDA graphs on
the card (``graph_info()`` counts captures and replays per bucket); the
parameter values follow the batch from bucket to bucket (copied in at a
switch) and the buckets share one optimizer and updater.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._fit_args = {}

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_names(self):
        return self._curr_module.output_names

    def _gen_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def graph_info(self):
        """bucket key -> its executor's captured signatures (replays and
        launches per replay)."""
        return {k: m._exec.graph_info() for k, m in self._buckets.items()}

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket (reference: bucketing_module.py bind)."""
        if self.binded and not force_rebind:
            return
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True
        self.for_training = for_training
        self._bind_args = dict(for_training=for_training,
                               inputs_need_grad=inputs_need_grad,
                               grad_req=grad_req)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Reference: bucketing_module.py switch_bucket — shares params with
        the default-bucket module."""
        assert self.binded
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, **self._bind_args)
            # share parameter values with the default bucket
            default = self._buckets[self._default_bucket_key]
            arg_params, aux_params = default.get_params()
            module.init_params(arg_params=arg_params, aux_params=aux_params,
                               allow_missing=False, force_init=True)
            if default.optimizer_initialized:
                module._optimizer = default._optimizer
                module._updater = default._updater
                module.optimizer_initialized = True
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def warmup_buckets(self, buckets, is_train=None):
        """Capture every bucket up front instead of mid-epoch.

        ``buckets`` is an iterable of ``(bucket_key, data_shapes)`` or
        ``(bucket_key, data_shapes, label_shapes)``. Each bucket is
        bound (sharing parameters with the default bucket, exactly like
        ``switch_bucket``) and its executor's graphs captured for the
        bucket's shapes via ``Module.warmup`` — parameters, aux states
        and gradients are untouched, and the module is switched back to
        the bucket that was current on entry. Returns the number of
        buckets warmed."""
        assert self.binded and self.params_initialized
        prev_key = self._curr_bucket_key
        count = 0
        for bucket in buckets:
            key, data_shapes = bucket[0], bucket[1]
            label_shapes = bucket[2] if len(bucket) > 2 else None
            self.switch_bucket(key, data_shapes, label_shapes)
            self._curr_module.warmup(is_train=is_train)
            count += 1
        if prev_key is not None and prev_key in self._buckets:
            self._curr_module = self._buckets[prev_key]
            self._curr_bucket_key = prev_key
        return count

    def init_params(self, *args, **kwargs):
        self._curr_module.init_params(*args, **kwargs)
        self.params_initialized = True

    def get_params(self):
        # sync current bucket's params as canonical
        return self._curr_module.get_params()

    def set_params(self, *args, **kwargs):
        self._curr_module.set_params(*args, **kwargs)
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        self._curr_module.init_optimizer(*args, **kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        """Switch to the batch's bucket, sharing params, then forward."""
        assert self.binded and self.params_initialized
        key = getattr(data_batch, "bucket_key", None)
        if key is not None and key != self._curr_bucket_key:
            prev = self._curr_module
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
            if prev is not self._curr_module:
                arg_params, aux_params = prev.get_params()
                self._curr_module.set_params(arg_params, aux_params)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()
        # propagate updated params to other buckets lazily at switch time

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)
