"""Module: symbolic training over one bound Executor.

The PyTorch counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py:40-646 — bind, init_params,
init_optimizer, forward, backward, update). One executor on one context
is the unit: a list of several contexts (the reference's
``DataParallelExecutorGroup``, the JAX package's mesh bind) waits for
slice 9b and raises. The executor's gradient requests follow the
reference's executor group: the parameters take ``grad_req``, the data
takes a gradient only with ``inputs_need_grad``, the labels never.

``init_optimizer`` makes and holds the kvstore, as the JAX module does
(``mxnet_tpu/module/module.py:236-238``): a type name is made with
``kvstore.create``, a ``KVStore`` is held, None holds none. ``update()``
runs the updater on each parameter in place. With a ``dist*`` store
over several ranks (``tools/launch.py``) it first sums the gradients
over the ranks in place, one collective per dtype, as the reference's
``update`` goes through the store; the JAX module never uses its store
in ``update`` and so trains each process alone (ROADMAP C).
"""
from __future__ import annotations

import logging

from .. import optimizer as opt
from ..base import MXNetError
from ..context import current_context
from ..executor import one_context
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        context = one_context(context)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._context = context
        self._group2ctxs = self._check_group2ctxs(group2ctxs, context)
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._arg_params = None
        self._aux_params = {}
        self._data_shapes = None
        self._label_shapes = None
        self.inputs_need_grad = False

    @staticmethod
    def _check_group2ctxs(group2ctxs, context):
        """A ``ctx_group`` placement that puts every group on the
        module's own context is honored; any other raises rather than
        train on one device in silence (the JAX module's rule)."""
        if not group2ctxs:
            return None
        base = str(context if context is not None else current_context())
        flat = {g: list(c) if isinstance(c, (list, tuple)) else [c]
                for g, c in dict(group2ctxs).items()}
        if all(len(cs) == 1 and str(cs[0]) == base for cs in flat.values()):
            return flat
        raise MXNetError(
            "group2ctxs placement across devices is not supported: bind "
            "every group to the module's own context")

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        if self._exec.outputs:
            return [(n, tuple(o.shape)) for n, o in
                    zip(self.output_names, self._exec.outputs)]
        if not self._exec.output_shapes:
            raise MXNetError(
                "output shapes unavailable (bind-time inference was "
                "invalidated by reshape) — run forward() once first")
        return list(zip(self.output_names, self._exec.output_shapes))

    def _param_names(self):
        inputs = set(self._data_names) | set(self._label_names)
        return [n for n in self._symbol.list_arguments() if n not in inputs]

    # -- bind -------------------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the symbol for these shapes (reference: module.py:364 bind
        → simple_bind), on the module's context (default: the current
        one, the card)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                              for d in (label_shapes or [])]
        shapes = {d.name: tuple(d.shape) for d in
                  self._data_shapes + self._label_shapes}
        req = grad_req if for_training else "null"
        reqs = {n: req for n in self._param_names()}
        for n in self._data_names:
            reqs[n] = req if inputs_need_grad else "null"
        self._exec = self._symbol.simple_bind(
            ctx=self._context, grad_req=reqs, **shapes)
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    # -- params -----------------------------------------------------------

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the parameters from ``arg_params``/``aux_params`` or the
        initializer, which sees each name as an ``InitDesc`` (reference:
        module.py init_params)."""
        assert self.binded
        if self.params_initialized and not force_init:
            return
        from .. import initializer as init_mod

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        if arg_params is None and self._arg_params is not None:
            arg_params = self._arg_params
        for name in self._param_names():
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                arg_params[name].copyto(arr)
            else:
                if arg_params is not None and not allow_missing:
                    raise RuntimeError(f"{name} is not presented")
                initializer(init_mod.InitDesc(name), arr)
        if aux_params is None and self._aux_params:
            aux_params = self._aux_params
        for name, arr in self._exec.aux_dict.items():
            # aux states keep their bind-time defaults (mean 0 / var 1)
            # unless a checkpoint provides them
            if aux_params and name in aux_params:
                aux_params[name].copyto(arr)
            elif aux_params and not allow_missing:
                raise RuntimeError(f"{name} is not presented")
        self.params_initialized = True

    def get_params(self):
        """Copies of the parameters and aux states (reference: module.py
        get_params)."""
        assert self.binded and self.params_initialized
        arg_params = {n: self._exec.arg_dict[n].copy()
                      for n in self._param_names()}
        aux_params = {n: a.copy() for n, a in self._exec.aux_dict.items()}
        aux_params.update({k: v for k, v in self._aux_params.items()
                           if k not in aux_params})
        return arg_params, aux_params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not self.binded:
            self._arg_params = arg_params
            self._aux_params = dict(aux_params or {})
            return
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    # -- optimizer --------------------------------------------------------

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer, its updater and the kvstore (reference:
        module.py init_optimizer); ``rescale_grad`` defaults to 1 / batch
        size, the batch of all the workers under a ``dist*`` synchronous
        store, whose ``update`` sums their gradients."""
        from .. import kvstore as kvs

        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if kvstore is not None and not isinstance(kvstore, (str,
                                                            kvs.KVStore)):
            raise MXNetError(f"kvstore must be a type name, a KVStore or "
                             f"None, got {type(kvstore).__name__}")
        store = kvs.create(kvstore) if isinstance(kvstore, str) and kvstore \
            else kvstore or None
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            idx2name = dict(enumerate(self._param_names()))
            if "rescale_grad" not in params and self._data_shapes:
                batch = self._data_shapes[0].shape[0]
                if store is not None and store.type.startswith("dist") \
                        and "_async" not in store.type:
                    # the gradients are summed over the workers' batches
                    # (reference: module.py init_optimizer)
                    batch *= store.num_workers
                params["rescale_grad"] = 1.0 / batch
            optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                   **params)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._kvstore = store
        self.optimizer_initialized = True

    # -- monitor ----------------------------------------------------------

    def install_monitor(self, mon):
        """Tap every op output (``callback(name, NDArray)``, or an object
        with ``install_to_executor``); the executor then runs eagerly."""
        assert self.binded, "call bind() before install_monitor"
        if hasattr(mon, "install_to_executor"):
            mon.install_to_executor(self._exec)
        else:
            self._exec.set_monitor_callback(mon)

    # -- step -------------------------------------------------------------

    def warmup(self, is_train=None):
        """Capture this module's graphs for its bound shapes (see
        ``Executor.warmup``): no output, gradient or aux state changes."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec.warmup(is_train=is_train)

    def forward(self, data_batch, is_train=None):
        """Feed the batch's data and labels and run the executor
        (reference: module.py forward)."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads)

    def update(self):
        """One updater call per parameter, in place (reference:
        module.py update), after the sum over the ranks with a ``dist*``
        store."""
        assert self.optimizer_initialized
        grads = self._exec.grad_dict
        kv = self._kvstore
        if kv is not None and kv.type.startswith("dist") and \
                kv.num_workers > 1:
            import torch

            from .. import parallel

            names = [n for n in self._param_names()
                     if n not in self._fixed_param_names and n in grads]
            gs = [grads[n] for n in names]
            with torch.no_grad():
                for g, r in zip(gs, parallel.all_reduce_coalesced(gs)):
                    g.data.copy_(r.data)
        for i, name in enumerate(self._param_names()):
            if name in self._fixed_param_names or name not in grads:
                continue
            self._updater(i, grads[name], self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict[n] for n in self._data_names
                if n in self._exec.grad_dict]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self.output_names, self._exec.outputs)))

    # -- checkpoint -------------------------------------------------------

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` and ``prefix-NNNN.params`` (and the
        updater's states) (reference: module.py save_checkpoint)."""
        from ..model import save_checkpoint

        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol, its parameters set at the
        next bind (reference: module.py Module.load)."""
        from ..model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=kwargs.get("context"))
        mod = Module(symbol, **kwargs)
        mod._arg_params = arg_params
        mod._aux_params = dict(aux_params or {})
        return mod
