"""Gluon Block / HybridBlock over ``torch.nn.Module``.

The PyTorch counterpart of ``mxnet_tpu/gluon/block.py:92,156,279,292,522``
(reference: python/mxnet/gluon/block.py). A :class:`Block` is an
``nn.Module``: its children are the module's submodules, and each
Gluon :class:`~.parameter.Parameter` registers its tensor on the block
once it is initialized. MXNet's naming survives — ``name_scope``
prefixes, ``collect_params`` and the structural names of
``_collect_params_with_prefix`` — so checkpoints and carried weights
line up with the JAX package. ``hybrid_forward(F, ...)`` runs with
``F`` = the port's ``nd`` module, so model files port line for line.
A block's forward builds an autograd graph only inside
``autograd.record()``; outside it, grad mode is off for the call.
:class:`SymbolBlock` runs a symbol graph (an export loaded with
:meth:`SymbolBlock.imports`) through the graph optimizer.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import ndarray as nd
from ..base import MXNetError
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope(threading.local):
    def __init__(self):
        self.current = None
        self.counters = {}


_SCOPE = _BlockScope()


def _gen_prefix(hint):
    if _SCOPE.current is None:
        counters = _SCOPE.counters
        base = ""
    else:
        counters = _SCOPE.current._counters
        base = _SCOPE.current.prefix
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{base}{hint}{idx}_"


class _NameScope:
    def __init__(self, block):
        self._block = block
        self._old = None

    def __enter__(self):
        self._old = _SCOPE.current
        _SCOPE.current = self._block
        return self

    def __exit__(self, *exc):
        _SCOPE.current = self._old


class Block(torch.nn.Module):
    """Base building block (reference: gluon/block.py:228)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = prefix if prefix is not None else \
            _gen_prefix(type(self).__name__.lower())
        self._params = ParameterDict(params.prefix if params is not None
                                     else self._prefix)
        if params is not None:
            self._params.update(params)
        self._reg_params = {}
        self._counters = {}

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    @property
    def _children(self):
        return self._modules

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else \
            self._prefix

    def name_scope(self):
        """Reference: gluon/block.py name_scope."""
        return _NameScope(self)

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Reference: gluon/block.py:372 collect_params with regex select."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, ``gpu(0)`` unless a scope says otherwise)."""
        from .. import initializer

        self.collect_params().initialize(init or initializer.Uniform(), ctx,
                                         verbose, force_reinit)

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        ``dtype`` (reference: gluon/block.py cast); layers may pin their
        own (``BatchNorm`` keeps float32 under a half cast)."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def _collect_params_with_prefix(self, prefix=""):
        """Structure-based parameter names ("0.weight", "body.1.bias"),
        the names the JAX package's ``save_parameters`` writes."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def __call__(self, *args, **kwargs):
        with autograd._grad_mode():
            return super().__call__(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block written as ``hybrid_forward(F, x, *args, **params)``
    (reference: gluon/block.py:838)."""

    def hybridize(self, active=True, **kwargs):
        """Accepted and does nothing yet: the port runs blocks eagerly.
        Compiling the forward (the reference's ``CachedOp``) comes in a
        later slice."""
        super().hybridize(active, **kwargs)

    def forward(self, x, *args):
        """Dispatch to ``hybrid_forward`` with the parameters as keyword
        arguments, finishing deferred initialization from ``x`` first."""
        params = {}
        for name, param in self._reg_params.items():
            try:
                params[name] = param.data()
            except DeferredInitializationError:
                self._infer_param_shapes(x, *args)
                params[name] = param.data()
        return self.hybrid_forward(nd, x, *args, **params)

    def _infer_param_shapes(self, x, *args):
        infer = getattr(self, "infer_param_shapes", None)
        if infer is None:
            raise DeferredInitializationError(
                f"{type(self).__name__} has deferred parameters and no "
                "shape-inference hook; call initialize() with known shapes")
        infer(x, *args)
        for p in self._reg_params.values():
            if p._ndarray is None and p._deferred_init is not None:
                p._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A block over a symbol graph (reference: gluon/block.py:1190; the
    JAX package's ``block.py:655-742``). Every free variable of
    ``outputs`` that is not one of ``inputs`` becomes a parameter of
    that name.

    Each forward evaluates the graph as ``MXNET_GRAPH_OPT`` optimizes
    it. The optimized graph is cached per (level, pipeline version,
    fusion configuration, device, input shapes and dtypes): the fusion
    pass picks each cluster's implementation for the device and the
    shapes it sees, so a graph optimized for the CPU (the replays) is
    never run on the card, and a bucket's shapes are checked against
    what the kernels take. (The JAX package optimizes without shapes;
    here the kernel choice depends on them.)"""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        self._outputs = outputs
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._graph_opt_cache = {}
        input_names = {i.name for i in self._inputs}
        for s in outputs._walk():
            if s._op is None and not s._group \
                    and s._name not in input_names \
                    and s._name not in self._reg_params:
                p = self.params.get(s._name, allow_deferred_init=True)
                self._reg_params[s._name] = p
                p._attach(self, s._name)

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, ctx=None):
        """A SymbolBlock from an export: ``symbol_file`` (nnvm JSON) and
        ``param_file`` (``nd.save`` format, keys optionally ``arg:``/
        ``aux:``-prefixed), with the parameters on ``ctx`` (default: the
        current context). ``input_names=None`` takes the data inputs to
        be the graph's free variables the params file does not hold."""
        from .. import cpu
        from .. import symbol as sym

        outputs = sym.load(symbol_file)
        loaded = None
        if param_file is not None:
            # host arrays first: each parameter then lands on ctx once
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v for k, v in
                      nd.load(param_file, ctx=cpu()).items()}
        if input_names is None:
            if loaded is None:
                raise MXNetError(
                    "SymbolBlock.imports(input_names=None) needs param_file "
                    "to tell data inputs from parameters")
            input_names = [n for n in outputs.list_arguments()
                           if n not in loaded]
            if not input_names:
                raise MXNetError(
                    f"no free variables of {symbol_file!r} remain after "
                    f"binding {param_file!r}; pass input_names explicitly")
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(outputs, [sym.var(n) for n in input_names])
        if loaded is not None:
            params = dict(ret.collect_params().items())
            missing = sorted(set(params) - set(loaded))
            extra = sorted(set(loaded) - set(params))
            if missing or extra:
                raise IOError(f"{param_file!r} does not match the graph: "
                              f"missing {missing[:5]}, extra {extra[:5]}")
            for name, arr in loaded.items():
                params[name].set_data(arr, ctx=ctx)
        return ret

    def _feed(self, args):
        feed = {i.name: a for i, a in zip(self._inputs, args)}
        for name, p in self.collect_params().items():
            feed[name] = p.data()
        return feed

    def _optimized_outputs(self, *args):
        """The output graph as ``MXNET_GRAPH_OPT`` rewrites it for the
        device, shapes and dtypes of ``args`` (the forward's inputs) and
        the parameters; cached (see the class docstring)."""
        return self._optimized_for(self._feed(args))

    def _optimized_for(self, feed):
        from ..analysis import graph_opt

        level = graph_opt.opt_level()
        if level <= 0:
            return self._outputs
        device = next(iter(feed.values())).data.device if feed else None
        shapes = {k: tuple(v.shape) for k, v in feed.items()}
        dtypes = {k: v.data.dtype for k, v in feed.items()}
        tag = (graph_opt.fingerprint_salt(level), str(device),
               tuple((i.name, shapes.get(i.name), str(dtypes.get(i.name)))
                     for i in self._inputs))
        opt = self._graph_opt_cache.get(tag)
        if opt is None:
            opt, _ = graph_opt.optimize_symbol(
                self._outputs, shapes=shapes, dtypes=dtypes, level=level,
                subject=f"hybridize:{self.name or 'symbol_block'}",
                device=device)
            self._graph_opt_cache[tag] = opt
        return opt

    def forward(self, *args):
        feed = self._feed(args)
        return self._optimized_for(feed).eval_with(feed)
