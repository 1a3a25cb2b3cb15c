"""Symbolic API (``mx.sym``).

The PyTorch counterpart of ``mxnet_tpu/symbol/__init__.py:26-383,
385-630,630-728`` (reference: python/mxnet/symbol/symbol.py). A
:class:`Symbol` is a node of a DAG of op nodes over the same op registry
that backs ``mx.nd``; the op namespace (``sym.convolution``,
``sym.LayerNorm``, ...) is generated from that registry, so a graph
written for the JAX package builds here call for call. Evaluation
(:meth:`Symbol.eval_with`) runs each node's op body eagerly on the
tensors fed in, on whatever device they live. ``tojson``/``load_json``
read and write the reference's nnvm JSON, and a graph either package
wrote loads in the other.

``simple_bind``/``bind`` (``mxnet_tpu/symbol/__init__.py:223-280``)
make an :class:`~mxnet_tpu_torch.executor.Executor`, which the Module
API trains through.

``sym.contrib`` holds the names of ``nd.contrib``'s ops and their
CamelCase spellings, ``sym.linalg`` and ``sym.image`` the ``linalg_*``
and ``image_*`` ops with the prefix stripped, all emitting graph nodes.
``mx.AttrScope`` (``attribute.py``) stamps the symbols made inside it,
and ``mx.name.Prefix`` prefixes their names.
"""
from __future__ import annotations

import ast
import inspect
import json
import sys as _sys
import types as _types

import numpy as onp
import torch

from .. import kernels as _kernels  # noqa: F401 — registers the fused ops
from .. import attribute as _attribute
from .. import name as _name_mod
from ..base import MXNetError
from ..ndarray import _CAMEL_ALIASES, _LOAD_ONLY, NDArray
from ..ndarray import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones"]

_DEVICE = "__device__"  # evaluation-cache slot: the device of the feed
# evaluation-cache slot: node key -> consumers still to run
_PENDING = "__pending__"


class Symbol:
    """A node (or a group of output nodes) of a symbolic graph."""

    def __init__(self, op=None, name=None, inputs=None, kwargs=None,
                 num_outputs=1, output_index=0, group=None):
        self._op = op  # op name; None for variables and groups
        self._name = name
        # views made by __getitem__ share these very objects with their
        # base node (node identity is (op, id(_inputs), id(_kwargs)))
        self._inputs = inputs if inputs is not None else []
        self._kwargs = kwargs if kwargs is not None else {}
        self._num_outputs = num_outputs
        self._output_index = output_index
        self._group = group  # list of Symbols for a Group
        self._attrs = {}
        self._consumers = None  # memo of _consumer_counts

    @property
    def name(self):
        return self._name

    def attr(self, key):
        return self._attrs.get(key)

    def _set_attr(self, **kwargs):
        self._attrs.update({k: str(v) for k, v in kwargs.items()})

    def list_attr(self):
        return dict(self._attrs)

    def __repr__(self):
        return f"<Symbol {self._name or self._op}>"

    def __copy__(self):
        return self

    # -- graph queries ---------------------------------------------------

    def _walk(self, seen=None, order=None):
        """Every node reachable from this one, inputs first."""
        if seen is None:
            seen, order = set(), []
        if id(self) in seen:
            return order
        seen.add(id(self))
        for i in self._inputs:
            i._walk(seen, order)
        if self._group:
            for g in self._group:
                g._walk(seen, order)
        order.append(self)
        return order

    def list_arguments(self):
        """Free variables in topological order, auxiliary states (tagged
        ``__aux__``) excluded."""
        return [s._name for s in self._walk()
                if s._op is None and s._group is None
                and "__aux__" not in s._attrs]

    def list_auxiliary_states(self):
        return [s._name for s in self._walk()
                if s._op is None and s._group is None
                and "__aux__" in s._attrs]

    def list_outputs(self):
        """``<name>_output`` per output (``_output<i>`` for a node with
        several), a group's in order."""
        if self._group:
            return [n for g in self._group for n in g.list_outputs()]
        base = self._name or self._op
        if self._num_outputs == 1:
            return [f"{base}_output"]
        return [f"{base}_output{i}" for i in range(self._num_outputs)]

    def get_internals(self):
        """Every op node of the graph as one group."""
        return Group([s for s in self._walk() if s._op is not None]
                     or [self])

    def __getitem__(self, index):
        if self._group:
            return self._group[index]
        if index < 0 or index >= self._num_outputs:
            raise IndexError(f"output index {index} out of range "
                             f"({self._num_outputs} outputs)")
        if self._num_outputs == 1 and index == 0:
            return self
        return Symbol(op=self._op, name=self._name, inputs=self._inputs,
                      kwargs=self._kwargs, num_outputs=self._num_outputs,
                      output_index=index)

    # -- evaluation ------------------------------------------------------

    def _eval_key(self):
        """Evaluation identity: output views of one node share it."""
        return (self._op, id(self._inputs), id(self._kwargs)) \
            if self._op is not None else id(self)

    def _eval_nodes(self, feed, cache):
        """Evaluate in topological order; ``feed`` maps variable names to
        NDArrays. Output views of one node share one evaluation. With a
        ``_PENDING`` count table in ``cache``, an op's value leaves the
        cache once its last consumer has run."""
        key = self._eval_key()
        if key in cache:
            out = cache[key]
            if self._op is not None and isinstance(out, (list, tuple)):
                return out[self._output_index] \
                    if self._num_outputs > 1 else out
            return out
        if self._group is not None:
            outs = []
            for g in self._group:
                o = g._eval_nodes(feed, cache)
                outs.extend(o if isinstance(o, (list, tuple)) else [o])
            cache[key] = outs
            return outs
        if self._op is None:
            if self._name not in feed:
                raise MXNetError(f"variable '{self._name}' is not bound")
            cache[key] = feed[self._name]
            return cache[key]
        args = []
        for i in self._inputs:
            v = i._eval_nodes(feed, cache)
            if isinstance(v, (list, tuple)):
                v = v[i._output_index]
            args.append(v)
        opdef = _registry.get_op(self._op)
        if opdef is None:
            raise MXNetError(f"op '{self._op}' is not registered")
        if not args and cache.get(_DEVICE) is not None:
            # a literal node (sym.zeros, a folded constant) is made where
            # the fed arrays live, not copied there (no host copy, so it
            # can sit inside a captured CUDA graph)
            with torch.device(cache[_DEVICE]):
                out = _registry.invoke(opdef, (), dict(self._kwargs))
        else:
            out = _registry.invoke(opdef, tuple(args), dict(self._kwargs))
        cache[key] = out
        pending = cache.get(_PENDING)
        if pending is not None:
            for i in self._inputs:
                ik = i._eval_key()
                pending[ik] -= 1
                if pending[ik] == 0 and i._op is not None:
                    del cache[ik]
        if isinstance(out, (list, tuple)):
            return out[self._output_index] if self._num_outputs > 1 else out
        return out

    def _consumer_counts(self):
        """Evaluation key -> how many ops read that value, the outputs
        once more (so they stay). Walked once per graph: rewrites make
        new nodes and never change an existing one's inputs."""
        if self._consumers is None:
            counts, seen = {}, set()
            for n in self._walk():
                k = n._eval_key()
                if n._op is None or k in seen:
                    continue
                seen.add(k)
                for i in n._inputs:
                    counts[i._eval_key()] = counts.get(i._eval_key(), 0) + 1
            for h in self._group or [self]:
                counts[h._eval_key()] = counts.get(h._eval_key(), 0) + 1
            self._consumers = counts
        return self._consumers

    def eval_with(self, feed):
        """The graph's output(s) for ``feed`` (variable name -> NDArray),
        computed on the device the fed arrays live on. Each intermediate
        is dropped once the last op that reads it has run, so the device
        holds the live values only, not every value of the forward."""
        return self._evaluate(feed, {})

    def _evaluate(self, feed, cache):
        """:meth:`eval_with` over the caller's (empty) cache dict, which
        sees every value land (``tools/profile_predict`` watches device
        memory through it)."""
        cache[_DEVICE] = next((v.data.device for v in feed.values()
                               if isinstance(v, NDArray)), None)
        cache[_PENDING] = dict(self._consumer_counts())
        out = self._eval_nodes(dict(feed), cache)
        if isinstance(out, (list, tuple)) and self._num_outputs > 1:
            return out[self._output_index]
        return out

    def eval(self, ctx=None, **kwargs):
        """The outputs, as a list, for the NDArrays ``kwargs`` (reference:
        symbol.py eval)."""
        out = self.eval_with(kwargs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    # -- shape and type inference ----------------------------------------

    def infer_shape(self, **kwargs):
        """``(argument shapes, output shapes, aux shapes)``: parameter
        shapes from the layer rules, output shapes from running each op
        body on meta tensors (``symbol/infer.py``)."""
        from .infer import infer_shapes

        var_shapes, out_shapes = infer_shapes(
            self, {k: tuple(v) for k, v in kwargs.items()})
        return ([var_shapes.get(a) for a in self.list_arguments()],
                out_shapes,
                [var_shapes.get(a) for a in self.list_auxiliary_states()])

    def infer_shape_partial(self, **kwargs):
        """:meth:`infer_shape` leaving unknown shapes as None."""
        from .infer import infer_shapes

        var_shapes, out_shapes = infer_shapes(
            self, {k: tuple(v) for k, v in kwargs.items()},
            allow_unknown=True)
        return ([var_shapes.get(a) for a in self.list_arguments()],
                out_shapes,
                [var_shapes.get(a) for a in self.list_auxiliary_states()])

    def infer_type(self, **kwargs):
        """``(argument dtypes, output dtypes, aux dtypes)``; unknown
        arguments take float32, as the reference's bind does."""
        from .infer import infer_types

        f32 = onp.dtype(onp.float32)
        var_types, out_types = infer_types(
            self, {k: onp.dtype(v) for k, v in kwargs.items()})
        return ([var_types.get(a, f32) for a in self.list_arguments()],
                out_types,
                [var_types.get(a, f32)
                 for a in self.list_auxiliary_states()])

    # -- binding ---------------------------------------------------------

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """An :class:`~mxnet_tpu_torch.executor.Executor` with arrays
        allocated from the shapes ``kwargs`` give (reference:
        MXExecutorSimpleBindEx): arguments and gradients zero, aux states
        at their defaults (variances one, the rest zero), all on ``ctx``
        (default: the current context, the card)."""
        from ..context import current_context
        from ..executor import Executor, one_context
        from ..ndarray import zeros

        ctx = one_context(ctx)
        ctx = current_context() if ctx is None else ctx
        arg_shapes, out_shapes, aux_shapes = self.infer_shape(**kwargs)
        args = self.list_arguments()
        aux = self.list_auxiliary_states()
        missing = [a for a, sh in zip(args, arg_shapes) if sh is None] + \
            [a for a, sh in zip(aux, aux_shapes) if sh is None]
        if missing:
            raise MXNetError(f"simple_bind could not infer shapes for "
                             f"{missing}")
        types = dict(type_dict or {})
        arg_arrays = [zeros(sh, ctx=ctx, dtype=types.get(n, "float32"))
                      for n, sh in zip(args, arg_shapes)]
        reqs = _grad_reqs(grad_req, args)
        grad_arrays = [None if r == "null" else zeros(
            sh, ctx=ctx, dtype=types.get(n, "float32"))
            for n, sh, r in zip(args, arg_shapes, reqs)]
        aux_arrays = [_default_aux_array(n, sh, ctx)
                      for n, sh in zip(aux, aux_shapes)]
        return Executor(self, args, arg_arrays, grad_arrays, reqs, ctx,
                        aux_names=aux, aux_arrays=aux_arrays,
                        output_shapes=out_shapes)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        """An Executor over the caller's arrays (reference: executor.h
        Bind): ``args``, ``args_grad`` and ``aux_states`` as lists in
        :meth:`list_arguments` order or dicts by name. The executor
        writes into those very arrays."""
        from ..context import current_context
        from ..executor import Executor

        names = self.list_arguments()
        arg_arrays = [args[n] for n in names] if isinstance(args, dict) \
            else list(args)
        if args_grad is None:
            grad_arrays = [None] * len(names)
        elif isinstance(args_grad, dict):
            grad_arrays = [args_grad.get(n) for n in names]
        else:
            grad_arrays = list(args_grad)
        reqs = [r if g is not None else "null" for r, g in
                zip(_grad_reqs(grad_req, names), grad_arrays)]
        aux = self.list_auxiliary_states()
        if ctx is None:
            ctx = arg_arrays[0].context if arg_arrays else current_context()
        if isinstance(aux_states, dict):
            aux_arrays = [aux_states[n] for n in aux]
        elif aux_states is not None:
            aux_arrays = list(aux_states)
        elif aux:
            _, _, aux_shapes = self.infer_shape(
                **{n: a.shape for n, a in zip(names, arg_arrays)})
            missing = [n for n, sh in zip(aux, aux_shapes) if sh is None]
            if missing:
                raise MXNetError(
                    f"bind could not infer aux-state shapes for {missing}; "
                    "pass aux_states explicitly")
            aux_arrays = [_default_aux_array(n, sh, ctx)
                          for n, sh in zip(aux, aux_shapes)]
        else:
            aux_arrays = []
        return Executor(self, names, arg_arrays, grad_arrays, reqs, ctx,
                        aux_names=aux, aux_arrays=aux_arrays)

    # -- serialization ---------------------------------------------------

    def tojson(self):
        """The reference's nnvm graph JSON: CamelCase legacy op names
        where they exist, every attribute value stringified MXNet-style
        ("(3, 3)", "True"), ``node_row_ptr`` and a version stamp — the
        same text the JAX package writes for the same graph."""
        rev = {}
        for k, v in _CAMEL_ALIASES.items():
            if k not in _LOAD_ONLY:
                rev.setdefault(v, k)
        order, idx = [], {}
        for s in self._walk():
            if s._group:
                continue
            if s._name not in idx:
                idx[s._name] = len(order)
                order.append(s)

        def attr_str(v):
            if isinstance(v, bool):
                return "True" if v else "False"
            if isinstance(v, (list, tuple)):
                return "(" + ", ".join(str(x) for x in v) + ")"
            return str(v)

        nodes, row_ptr = [], [0]
        for s in order:
            node = {
                "op": "null" if s._op is None else rev.get(s._op, s._op),
                "name": s._name or (s._op + str(idx[s._name])),
                "inputs": [[idx[i._name], i._output_index, 0]
                           for i in s._inputs],
            }
            merged = {}
            if s._op is not None and s._kwargs:
                merged.update({k: attr_str(v) for k, v in s._kwargs.items()})
            merged.update({k: attr_str(v) for k, v in s._attrs.items()})
            if merged:
                node["attrs"] = merged
            nodes.append(node)
            row_ptr.append(row_ptr[-1] + s._num_outputs)
        heads = ([[idx[g._name], g._output_index, 0] for g in self._group]
                 if self._group else [[idx[self._name],
                                       self._output_index, 0]])
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, s in enumerate(order) if s._op is None],
            "node_row_ptr": row_ptr,
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 10500]}}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- operators -------------------------------------------------------

    def _binop(self, opname, other, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _make_node(opname, [a, b], {})
        return _make_node(opname + "_scalar", [self],
                          {"scalar": other, "reverse": reverse})

    def __add__(self, o): return self._binop("broadcast_add", o)
    def __radd__(self, o): return self._binop("broadcast_add", o, True)
    def __sub__(self, o): return self._binop("broadcast_sub", o)
    def __rsub__(self, o): return self._binop("broadcast_sub", o, True)
    def __mul__(self, o): return self._binop("broadcast_mul", o)
    def __rmul__(self, o): return self._binop("broadcast_mul", o, True)
    def __truediv__(self, o): return self._binop("broadcast_div", o)
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, True)
    def __pow__(self, o): return self._binop("broadcast_power", o)
    def __neg__(self): return _make_node("negative", [self], {})

    def reshape(self, shape):
        return _make_node("reshape", [self], {"shape": shape})

    def transpose(self, axes=None):
        return _make_node("transpose", [self], {"axes": axes})


def Variable(name=None, shape=None, dtype=None, init=None, **kwargs):
    """A free variable (reference: symbol.py Variable); ``shape`` and
    ``dtype`` ride as the ``__shape__``/``__dtype__`` attributes."""
    if name is None:
        name = _name_mod.current().get(None, "var")
    s = Symbol(op=None, name=name)
    # the ambient AttrScope's attributes, explicit ``attr=`` winning
    scope_attrs = _attribute.current().get(kwargs.pop("attr", None))
    if scope_attrs:
        s._attrs.update({k: str(v) for k, v in scope_attrs.items()})
    if shape is not None:
        s._attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        s._attrs["__dtype__"] = str(onp.dtype(dtype))
    return s


var = Variable


def Group(symbols):
    """Several outputs as one symbol (reference: symbol.py Group)."""
    return Symbol(group=list(symbols), name="group")


def _grad_reqs(grad_req, names):
    """``grad_req`` (a string, a list in argument order or a dict by
    name, missing names "null") as one string per argument."""
    if isinstance(grad_req, str):
        reqs = [grad_req] * len(names)
    elif isinstance(grad_req, dict):
        reqs = [grad_req.get(n, "null") for n in names]
    else:
        reqs = list(grad_req)
    for r in reqs:
        if r not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be 'write', 'add' or 'null', "
                             f"got {r!r}")
    return reqs


def _default_aux_array(name, shape, ctx):
    """An aux state's bind-time value: a variance starts at one, anything
    else at zero (the reference's BatchNorm aux initialization)."""
    from ..ndarray import ones, zeros

    return (ones if name.endswith("var") else zeros)(shape, ctx=ctx)


def _num_outputs_for(opname, kwargs):
    """Static output count of a node: the norms with
    ``output_mean_var`` also return the mean and the variance;
    ``amp_multicast`` returns one output per input (its
    ``num_outputs``), the splits one per part, ``rnn`` with
    ``state_outputs`` its final states too; ``topk`` with ``ret_typ=
    "both"`` values and indices, ``sample_multinomial`` with
    ``get_prob`` the log-probabilities too, ``histogram`` counts and
    edges, ``moments`` the mean and the variance; ``ftml_update`` the
    weight and its three states, ``lamb_update_phase1`` the direction and
    both moments; ``linalg_gelqf`` (L, Q), ``linalg_syevd`` (U, L),
    ``linalg_slogdet`` (sign, log|det|); the quantization ops (data, min,
    max)."""
    if opname in ("batch_norm", "layer_norm"):
        return 3 if kwargs.get("output_mean_var") else 1
    if opname == "amp_multicast":
        return int(kwargs.get("num_outputs") or 1)
    if opname in ("split", "split_v2", "slice_channel"):
        n = kwargs.get("num_outputs")
        if n is None and opname == "split_v2":
            ios = kwargs.get("indices_or_sections")
            n = ios if isinstance(ios, int) else len(ios) + 1
        return int(n or 1)
    if opname == "rnn":
        if kwargs.get("state_outputs", True):
            return 3 if kwargs.get("mode", "lstm") == "lstm" else 2
        return 1
    if opname == "topk":
        return 2 if kwargs.get("ret_typ") == "both" else 1
    if opname == "sample_multinomial":
        return 2 if kwargs.get("get_prob") else 1
    if opname in ("histogram", "moments"):
        return 2
    if opname == "ftml_update":
        return 4
    if opname in ("lamb_update_phase1", "multibox_target"):
        return 3
    if opname in ("bipartite_matching", "linalg_gelqf", "linalg_syevd",
                  "linalg_slogdet"):
        return 2
    if opname in ("quantize", "quantize_v2", "requantize") or \
            opname.startswith("_contrib_quantized_"):
        # every quantized-lattice op emits (data, min, max) (reference:
        # src/operator/quantization/*.cc num_outputs=3)
        return 3
    return 1


def _make_node(opname, inputs, kwargs, name=None):
    """A node named by the innermost name manager when ``name`` is None,
    stamped with the ambient AttrScope's attributes."""
    if name is None:
        name = _name_mod.current().get(None, opname.lower())
    node = Symbol(op=opname, name=name, inputs=inputs, kwargs=kwargs,
                  num_outputs=_num_outputs_for(opname, kwargs))
    scope_attrs = _attribute.current().get(None)
    if scope_attrs:
        node._attrs.update(scope_attrs)
    return node


# input positions that are auxiliary states (the reference derives them
# from each op's FMutateInputs): re-derived whenever a node is built
_AUX_INPUT_SLOTS = {"batch_norm": (3, 4)}


def _mark_aux_inputs(node):
    for i in _AUX_INPUT_SLOTS.get(node._op, ()):
        if i < len(node._inputs):
            v = node._inputs[i]
            if v._op is None and v._group is None:
                v._attrs.setdefault("__aux__", "1")


# parameter inputs made as variables named {node}_{input} when a call
# leaves them out (the reference's NNVM composition)
_AUTO_PARAMS = {
    "fully_connected": ("weight", "bias"),
    "convolution": ("weight", "bias"),
    "embedding": ("weight",),
    "batch_norm": ("gamma", "beta", "moving_mean", "moving_var"),
    "layer_norm": ("gamma", "beta"),
    "deconvolution": ("weight", "bias"),
    "group_norm": ("gamma", "beta"),
    "instance_norm": ("gamma", "beta"),
}


def _sym_wrapper(opdef):
    sig = inspect.signature(opdef.fn)
    sig_names = [p.name for p in sig.parameters.values()
                 if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)]
    nb = sig.parameters.get("no_bias")
    no_bias_default = bool(nb.default) if nb is not None and \
        nb.default is not inspect.Parameter.empty else False

    def wrapper(*args, **kwargs):
        name = _name_mod.current().get(kwargs.pop("name", None),
                                       opdef.name.lower())
        attr = kwargs.pop("attr", None)
        bound = {}
        for i, a in enumerate(args):
            if i < len(sig_names):
                bound[sig_names[i]] = a
            elif isinstance(a, Symbol):
                bound[f"__extra{i}"] = a  # varargs ops (add_n, ...)
        bound.update(kwargs)
        auto = _AUTO_PARAMS.get(opdef.name)
        if auto and any(isinstance(v, Symbol) for v in bound.values()):
            no_bias = bool(bound.get("no_bias", no_bias_default))
            for key in auto:
                if key not in bound and not (key == "bias" and no_bias):
                    bound[key] = Variable(f"{name}_{key}")
        inputs, config = [], {}
        for key in sig_names:
            if key in bound:
                v = bound.pop(key)
                if isinstance(v, Symbol):
                    inputs.append(v)
                elif v is not None:
                    config[key] = v
        for key, v in bound.items():
            if isinstance(v, Symbol):
                inputs.append(v)
            else:
                config[key] = v
        node = _make_node(opdef.name, inputs, config, name=name)
        _mark_aux_inputs(node)
        if attr:
            node._set_attr(**attr)
        return node

    wrapper.__name__ = opdef.name
    wrapper.__doc__ = opdef.doc
    return wrapper


def _populate():
    mod = _sys.modules[__name__]
    for name in _registry.list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _sym_wrapper(_registry.get_op(name)))
    for alias, target in _CAMEL_ALIASES.items():
        if not hasattr(mod, alias) and hasattr(mod, target):
            setattr(mod, alias, getattr(mod, target))


_populate()

# ``mx.sym.contrib`` (reference: python/mxnet/symbol/contrib.py;
# ``mxnet_tpu/symbol/__init__.py:607-618``): nd.contrib's op names,
# emitting graph nodes, with the same fail-fast on a listed name that is
# not registered
contrib = _types.ModuleType(__name__ + ".contrib")
from ..ndarray.contrib import _CONTRIB_ALIASES, _CONTRIB_OPS  # noqa: E402

for _cname in _CONTRIB_OPS:
    _cdef = _registry.get_op(_cname) or _registry.get_op(_cname.lower())
    if _cdef is None:
        raise RuntimeError(f"contrib op '{_cname}' listed but unregistered")
    setattr(contrib, _cname, _sym_wrapper(_cdef))
for _alias, _target in _CONTRIB_ALIASES.items():
    setattr(contrib, _alias, getattr(contrib, _target))
_sys.modules[contrib.__name__] = contrib


def _sym_prefix_namespace(short):
    """``mx.sym.<short>``: the ``<short>_*`` ops, the prefix stripped
    (reference: python/mxnet/symbol/{linalg,image}.py)."""
    mod = _types.ModuleType(__name__ + "." + short)
    pre = short + "_"
    for name in _registry.list_ops():
        if name.startswith(pre):
            setattr(mod, name[len(pre):], _sym_wrapper(_registry.get_op(name)))
    _sys.modules[mod.__name__] = mod
    return mod


linalg = _sym_prefix_namespace("linalg")
image = _sym_prefix_namespace("image")


def zeros(shape, dtype="float32", **kwargs):
    return _make_node("_sym_zeros", [], {"shape": shape, "dtype": dtype})


def ones(shape, dtype="float32", **kwargs):
    return _make_node("_sym_ones", [], {"shape": shape, "dtype": dtype})


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _parse_attr_value(v):
    """An MXNet-stringified attribute ("(3, 3)", "True", "2", "0.9",
    "gelu") back to its Python value."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    low = v.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    return v


def load_json(json_str):
    """Rebuild a Symbol DAG from nnvm JSON: this package's, the JAX
    package's or a reference-era file (CamelCase op names, stringified
    attributes, ``attr``/``param`` in old files). Attributes the op's
    signature does not name stay symbol attributes."""
    obj = json.loads(json_str)
    built = []
    for n in obj["nodes"]:
        if n["op"] == "null":
            v = Symbol(op=None, name=n["name"])
            v._attrs.update({k: str(a) for k, a in
                             (n.get("attrs") or {}).items()})
            built.append(v)
            continue
        inputs = [built[i] if oi == 0 else built[i][oi]
                  for i, oi, *_ in n["inputs"]]
        opname = n["op"]
        opdef = _registry.get_op(opname)
        if opdef is None:
            mapped = _CAMEL_ALIASES.get(opname)
            if mapped is None or _registry.get_op(mapped) is None:
                raise MXNetError(f"unknown op '{opname}' in symbol JSON")
            opname = mapped
            opdef = _registry.get_op(opname)
        attrs = n.get("attrs", n.get("attr", n.get("param", {}))) or {}
        sig = inspect.signature(opdef.fn)
        accepts_kw = any(p.kind == p.VAR_KEYWORD
                         for p in sig.parameters.values())
        kwargs = {k: _parse_attr_value(v) for k, v in attrs.items()
                  if (accepts_kw or k in sig.parameters)
                  and not k.startswith("__")}
        node = Symbol(op=opname, name=n["name"], inputs=inputs,
                      kwargs=kwargs,
                      num_outputs=n.get("num_outputs",
                                        _num_outputs_for(opname, kwargs)))
        node._attrs.update({k: str(v) for k, v in attrs.items()
                            if k not in kwargs})
        _mark_aux_inputs(node)
        built.append(node)
    heads = [built[i] if oi == 0 else built[i][oi]
             for i, oi, *_ in obj["heads"]]
    return heads[0] if len(heads) == 1 else Group(heads)
