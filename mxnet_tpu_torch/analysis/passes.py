"""Verifier passes over a Symbol DAG, and the fact cache they share.

The PyTorch counterpart of ``mxnet_tpu/analysis/passes.py``. Each pass
is ``pass_fn(ctx)`` over a :class:`PassContext` (the symbol, the shapes
and dtypes the caller knows, memoized analyses) and emits diagnostics:

- ``shape``: partial shape inference (``symbol/infer.py``) seeded from
  declared ``__shape__`` attributes and the caller's shapes, with the
  known parameter shapes held against the layer rules (GV101);
- ``dtype``: dtype propagation held against declared ``__dtype__``
  attributes (GV102);
- ``structure``: duplicate node names (GV403) and dead outputs of
  multi-output nodes (GV401).

- ``eval_shape``: the whole graph run on torch's ``meta`` device (every
  op body on tensors with shapes and no data, the counterpart of the JAX
  package's ``jax.eval_shape``), its output shapes held against the
  inference pass's (GV103).

Expensive analyses are *facts*, computed once per context by
``ctx.fact(name)``; ``analysis/fusion.py`` adds the pattern and per-node
shape facts.
"""
from __future__ import annotations

import ast

import numpy as onp

from ..base import MXNetError
from .diagnostics import DiagnosticReport

__all__ = ["FactError", "PassContext", "PASSES", "register_fact",
           "run_passes", "verify_symbol"]


class FactError:
    """A fact whose analysis failed; cached like any other fact so the
    failure is not re-attempted per pass."""

    def __init__(self, message):
        self.message = message

    def __repr__(self):
        return f"FactError({self.message!r})"


FACT_PROVIDERS = {}  # fact name -> provider(ctx)


def register_fact(name, provider):
    """Install a fact provider (computed at most once per context)."""
    FACT_PROVIDERS[name] = provider
    return provider


def _opt_count(name, n=1):
    from .graph_opt import _count

    _count(name, n)


class PassContext:
    """One verification or optimization run over ``symbol``: the
    caller's known shapes and dtypes, the report and the fact cache."""

    def __init__(self, symbol, shapes=None, dtypes=None, subject=None):
        self.symbol = symbol
        self.known_shapes = {k: tuple(v) for k, v in (shapes or {}).items()}
        # dtype names or torch dtypes, as the caller gave them
        self.known_dtypes = dict(dtypes or {})
        self.report = DiagnosticReport(subject=subject)
        self.var_shapes = None  # set by the shape pass
        self.out_shapes = None
        self.facts = {}
        self.passes_run = set()

    def fact(self, name):
        """The memoized analysis ``name``, computed on first request."""
        if name in self.facts:
            _opt_count("fact_cache_hits")
            return self.facts[name]
        value = FACT_PROVIDERS[name](self)
        self.facts[name] = value
        return value

    def nodes(self):
        """Walked nodes with the output views of one node collapsed to
        one representative."""
        seen, out = set(), []
        for s in self.symbol._walk():
            if s._group is not None:
                continue
            key = self.node_key(s)
            if key not in seen:
                seen.add(key)
                out.append(s)
        return out

    @staticmethod
    def node_key(s):
        if s._op is None:
            return ("var", s._name)
        return (s._op, id(s._inputs), id(s._kwargs))

    def heads(self):
        return self.symbol._group if self.symbol._group else [self.symbol]

    def declared_shapes(self):
        out = {}
        for s in self.nodes():
            if s._op is None and "__shape__" in s._attrs:
                try:
                    out[s._name] = tuple(
                        ast.literal_eval(s._attrs["__shape__"]))
                except (ValueError, SyntaxError):
                    pass
        return out

    def declared_dtypes(self):
        out = {}
        for s in self.nodes():
            if s._op is None and "__dtype__" in s._attrs:
                try:
                    out[s._name] = onp.dtype(s._attrs["__dtype__"])
                except TypeError:
                    pass
        return out

    def known(self):
        """Declared shapes overridden by the caller's."""
        known = dict(self.declared_shapes())
        known.update(self.known_shapes)
        return known


def _shapes_fact(ctx):
    """``(var_shapes, out_shapes)`` of partial inference, or a
    FactError."""
    from ..symbol.infer import infer_shapes

    _opt_count("shape_analysis_runs")
    try:
        return infer_shapes(ctx.symbol, ctx.known(), allow_unknown=True,
                            dtypes=ctx.known_dtypes)
    except MXNetError as e:
        return FactError(str(e))


def _dtypes_fact(ctx):
    """``(var_types, out_types)`` of dtype propagation, or a FactError."""
    from ..symbol.infer import infer_types

    known = dict(ctx.declared_dtypes())
    _opt_count("dtype_analysis_runs")
    try:
        known.update({k: onp.dtype(str(v).replace("torch.", ""))
                      for k, v in ctx.known_dtypes.items()})
        return infer_types(ctx.symbol, known)
    except Exception as e:
        return FactError(str(e))


register_fact("shapes", _shapes_fact)
register_fact("dtypes", _dtypes_fact)


def shape_pass(ctx):
    from ..ndarray import registry as _registry
    from ..symbol.infer import _array_arg_names, _param_shape_rules

    declared = ctx.declared_shapes()
    for name, shp in ctx.known_shapes.items():
        if name in declared and tuple(declared[name]) != tuple(shp):
            ctx.report.emit(
                "GV101", f"variable '{name}' is declared with shape "
                f"{declared[name]} but bound with shape {tuple(shp)}",
                node=name, hint="fix the Variable(shape=...) declaration "
                "or the bound array")
    result = ctx.fact("shapes")
    if isinstance(result, FactError):
        ctx.report.emit("GV101", result.message,
                        hint="check the input shapes fed to this graph")
        return
    var_shapes, out_shapes = result
    ctx.var_shapes, ctx.out_shapes = var_shapes, out_shapes
    # known parameter shapes against the rules that would derive them
    for node in ctx.nodes():
        if node._op is None:
            continue
        opdef = _registry.get_op(node._op)
        if opdef is None:
            ctx.report.emit("GV101", f"op '{node._op}' is not registered",
                            node=node._name)
            continue
        in_shapes = {i: tuple(var_shapes[inp._name])
                     for i, inp in enumerate(node._inputs)
                     if inp._op is None and inp._name in var_shapes}
        if 0 not in in_shapes:
            continue
        try:
            rules = _param_shape_rules(node._op, node._kwargs, in_shapes,
                                       _array_arg_names(opdef))
        except Exception:
            continue  # a rule that cannot run is not a user error
        for i, want in rules.items():
            if i >= len(node._inputs) or node._inputs[i]._op is not None:
                continue
            inp = node._inputs[i]
            have = var_shapes.get(inp._name)
            if have is not None and tuple(have) != tuple(want):
                ctx.report.emit(
                    "GV101", f"parameter '{inp._name}' has shape "
                    f"{tuple(have)} but op '{node._op}' ({node._name}) "
                    f"requires {tuple(want)} given data shape "
                    f"{in_shapes[0]}", node=f"{node._name}/{inp._name}",
                    hint=f"declare '{inp._name}' with shape {tuple(want)} "
                    "or fix the layer config")


def dtype_pass(ctx):
    declared = ctx.declared_dtypes()
    for name, dt in ctx.known_dtypes.items():
        bound = onp.dtype(str(dt).replace("torch.", ""))
        if name in declared and declared[name] != bound:
            ctx.report.emit(
                "GV102", f"variable '{name}' is declared {declared[name]} "
                f"but bound as {bound}", node=name,
                hint="fix the Variable(dtype=...) declaration or cast the "
                "bound array")
    result = ctx.fact("dtypes")
    if isinstance(result, FactError):
        ctx.report.emit("GV102",
                        f"dtype inference failed: {result.message}")
        return
    var_types, _ = result
    for name, want in declared.items():
        have = var_types.get(name)
        if have is not None and onp.dtype(have) != onp.dtype(want):
            ctx.report.emit(
                "GV102", f"variable '{name}' is declared {want} but "
                f"inference assigns {have}", node=name,
                hint="insert an explicit cast or fix the declaration")


def structure_pass(ctx):
    by_name = {}
    for node in ctx.nodes():
        if node._name is None:
            continue
        prev = by_name.get(node._name)
        if prev is not None and ctx.node_key(prev) != ctx.node_key(node):
            ctx.report.emit(
                "GV403", f"two distinct nodes share the name "
                f"'{node._name}' (ops: {prev._op or 'variable'} and "
                f"{node._op or 'variable'})", node=node._name,
                hint="name symbols uniquely; serialization merges "
                     "same-named nodes")
        else:
            by_name[node._name] = node
    consumed = {}
    for s in ctx.symbol._walk():
        if s._group is None:
            for inp in s._inputs:
                consumed.setdefault(ctx.node_key(inp), set()).add(
                    inp._output_index)
    live_heads = {}
    for h in ctx.heads():
        n_out = getattr(h, "_num_outputs", 1) or 1
        outs = range(n_out) if (n_out > 1 and h._output_index == 0
                                and h._op is not None) \
            else [h._output_index]
        live_heads.setdefault(ctx.node_key(h), set()).update(outs)
    for node in ctx.nodes():
        n_out = getattr(node, "_num_outputs", 1) or 1
        if node._op is None or n_out <= 1:
            continue
        key = ctx.node_key(node)
        live = consumed.get(key, set()) | live_heads.get(key, set())
        dead = sorted(set(range(n_out)) - live)
        if dead:
            ctx.report.emit(
                "GV401", f"op '{node._op}' ({node._name}) computes {n_out} "
                f"outputs but outputs {dead} are never consumed",
                node=node._name, hint="drop the unused outputs or "
                "consume them")


def eval_shape_cross_check(ctx):
    """The graph's op bodies run on ``meta`` tensors against the
    inference pass (GV103: ``symbol/infer.py`` has drifted from what the
    ops compute). Runs only with every argument shape known; float32
    arguments, as the JAX pass feeds ``jax.ShapeDtypeStruct``s."""
    import torch

    from .. import autograd
    from ..ndarray import NDArray

    if ctx.var_shapes is None or ctx.out_shapes is None:
        return
    if any(s is None for s in ctx.out_shapes):
        return
    symbol = ctx.symbol
    names = symbol.list_arguments() + symbol.list_auxiliary_states()
    shapes = [ctx.var_shapes.get(n) for n in names]
    if any(s is None for s in shapes):
        return  # partial information: nothing sound to compare
    feed = {n: NDArray(torch.empty(tuple(s), dtype=torch.float32,
                                   device="meta"))
            for n, s in zip(names, shapes)}
    try:
        with autograd.pause():
            out = symbol._eval_nodes(feed, {})
    except Exception:  # noqa: BLE001 — bodies that need values or ints
        return  # not comparable
    outs = out if isinstance(out, (list, tuple)) else [out]
    observed = [tuple(o.shape) for o in outs]
    inferred = [tuple(s) for s in ctx.out_shapes]
    if len(observed) != len(inferred):
        return  # head-view flattening differs; a pairwise compare is unsound
    for i, (obs, inf) in enumerate(zip(observed, inferred)):
        if obs != inf:
            ctx.report.emit(
                "GV103",
                f"output {i}: inference pass says {inf} but the op "
                f"bodies produce {obs}",
                node=ctx.heads()[min(i, len(ctx.heads()) - 1)]._name,
                hint="symbol/infer.py has drifted from the op registry; "
                     "file a framework bug")


PASSES = {"shape": shape_pass, "eval_shape": eval_shape_cross_check,
          "dtype": dtype_pass, "structure": structure_pass}
#: shape first (eval_shape reads its result)
DEFAULT_PIPELINE = ("shape", "eval_shape", "dtype", "structure")


def run_passes(ctx, passes=None):
    for name in (passes or DEFAULT_PIPELINE):
        PASSES[name](ctx)
        ctx.passes_run.add(name)
    return ctx.report



def verify_symbol(symbol, shapes=None, dtypes=None, passes=None,
                  subject=None):
    """Run the verifier pipeline over a Symbol DAG; returns the
    ``DiagnosticReport`` (not yet dispositioned: ``.disposition()``
    applies the ``MXNET_GRAPH_VERIFY`` mode)."""
    ctx = PassContext(symbol, shapes=shapes, dtypes=dtypes,
                      subject=subject or getattr(symbol, "_name", None))
    return run_passes(ctx, passes)
