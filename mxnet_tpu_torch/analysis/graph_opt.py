"""The graph optimizer: analyze-and-rewrite passes over symbol graphs.

The PyTorch counterpart of ``mxnet_tpu/analysis/graph_opt.py``. The
verifier's ``PassContext`` fact cache feeds typed passes:

- ``AnalysisPass`` — a named, memoized fact about the original graph
  (the fusion pass's patterns and node shapes);
- ``RewritePass`` — builds an ``old node -> replacement`` mapping over
  the mutable :class:`_Graph` work list and applies it. A rewrite never
  mutates an existing ``Symbol``: every change is a fresh node, and
  untouched subgraphs are shared by identity.

The pipeline, in order: ``fold`` (constant folding of pure literal
subgraphs into ``_sym_constant`` nodes), ``cse`` (value numbering,
purity-gated), ``transpose_elision`` (inverse transposes cancel,
reshape chains collapse), ``fusion`` (``analysis/fusion.py``: clusters
become fused kernel ops) and ``dce`` (nodes no head reaches are
dropped).

``MXNET_GRAPH_OPT=0`` (default) is off, ``1`` one sweep, ``2`` a bounded
fixpoint. The verifier's cheap passes run again on every optimized
graph, and a rewrite that adds an error diagnostic is rejected: the
original graph is served and the rejection counted — except when the
fusion pass rewrote a graph optimized for a CUDA device, where serving
the original would bypass the kernels unseen: that raises
:class:`MXNetError`. The counters are a
plain dict under a lock (:func:`counters`). The int8 quantization
passes (``quantize_insert``, ``quantize_elide``, ``quantize_calibrate``,
``analysis/quantize.py``) register here too and run as
``QUANTIZE_PIPELINE`` under the same rejection net: a quantized rewrite
that adds an error diagnostic serves the float32 graph. Not ported yet:
the telemetry spans and the artifact-layer salt provider.
"""
from __future__ import annotations

import logging
import os
import threading
import time

from ..base import MXNetError
from .passes import FactError, PassContext, register_fact, run_passes

__all__ = [
    "AnalysisPass", "RewritePass", "PassManager", "PIPELINE_VERSION",
    "DEFAULT_REWRITE_PIPELINE", "REWRITE_PASSES", "opt_level",
    "optimize_symbol", "op_is_pure",
    "fingerprint_salt", "counters", "reset_counters",
]

#: version stamp of the rewrite pipeline, part of every cache key that
#: can see optimized graphs
PIPELINE_VERSION = "graphopt-r19.0"

#: verifier passes run before and after rewriting
PRE_PASSES = ("shape", "dtype", "structure")

_FOLD_MAX_ELEMENTS = 65536

_key = PassContext.node_key

# -- counters ---------------------------------------------------------------

_GRAPH_COUNTERS = ("graphs_seen", "graphs_optimized", "graphs_rejected",
                   "nodes_before_total", "nodes_after_total",
                   "rewrites_total", "shape_analysis_runs",
                   "dtype_analysis_runs", "fact_cache_hits")
# guards: _COUNTERS, _PASS_COUNTERS
_COUNT_LOCK = threading.Lock()
_COUNTERS = dict.fromkeys(_GRAPH_COUNTERS, 0)
_PASS_COUNTERS = {}  # "<pass>_rewrites" / "<pass>_time_ms"


def _count(name, n=1):
    with _COUNT_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def _count_pass(name, rewrites, time_ms):
    with _COUNT_LOCK:
        for k, v in ((f"{name}_rewrites", rewrites),
                     (f"{name}_time_ms", time_ms)):
            _PASS_COUNTERS[k] = _PASS_COUNTERS.get(k, 0) + v


def counters():
    """Graph totals, per-pass rewrite counts and cumulative time, and
    the analysis-run and fact-cache tallies."""
    with _COUNT_LOCK:
        out = dict(_COUNTERS)
        out.update((k, round(v, 3) if k.endswith("_time_ms") else v)
                   for k, v in sorted(_PASS_COUNTERS.items()))
    return out


def reset_counters():
    with _COUNT_LOCK:
        _COUNTERS.clear()
        _COUNTERS.update(dict.fromkeys(_GRAPH_COUNTERS, 0))
        _PASS_COUNTERS.clear()


# -- gating -----------------------------------------------------------------

def lvl_clamp(level):
    return max(0, min(2, int(level)))


def opt_level():
    """``MXNET_GRAPH_OPT`` clamped to {0, 1, 2}, read at every
    optimization point."""
    try:
        return lvl_clamp(os.environ.get("MXNET_GRAPH_OPT", 0))
    except ValueError:
        logging.warning("invalid integer for MXNET_GRAPH_OPT; using 0")
        return 0


def fingerprint_salt(level=None):
    """Cache-key element of graph-opt-aware caches: the pipeline version
    and the fusion configuration when optimization is armed."""
    lvl = opt_level() if level is None else lvl_clamp(level)
    if lvl > 0:
        from .. import kernels

        return ("graph_opt", lvl, PIPELINE_VERSION, kernels.fusion_salt())
    return ("graph_opt", 0)


# -- purity -----------------------------------------------------------------

#: ops that draw random numbers: never folded, never merged
_IMPURE_SUBSTRINGS = ("dropout", "random")
_IMPURE_PREFIXES = ("sample_", "_sample", "_random")
_IMPURE_EXACT = {"uniform", "normal", "gamma", "shuffle", "multinomial",
                 "rnn"}
#: ops with effects beyond their outputs (BatchNorm's running stats)
_EFFECTFUL_OPS = {"batch_norm"}


def op_is_pure(op):
    """Conservative purity: False for anything that draws random state
    or carries effects; variables and other ops are pure."""
    if op is None:
        return True
    low = op.lower()
    if low in _EFFECTFUL_OPS or any(t in low for t in _IMPURE_SUBSTRINGS):
        return False
    if low.startswith(_IMPURE_PREFIXES):
        return False
    return low not in _IMPURE_EXACT


_CONST_OPS = {"_sym_zeros", "_sym_ones", "_sym_constant"}


# -- the work list ----------------------------------------------------------

class _Graph:
    """Node work list and heads of one optimization run. The list
    persists across rewrites, so a rewrite that re-points a consumer
    leaves the orphaned producer in it, for ``dce`` to count and drop."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.heads = list(symbol._group) if symbol._group else [symbol]
        self.nodes = []
        self._keys = set()
        for s in symbol._walk():
            if s._group is not None:
                continue
            k = _key(s)
            if k not in self._keys:
                self._keys.add(k)
                self.nodes.append(s)

    def by_key(self):
        return {_key(n): n for n in self.nodes}

    def apply(self, mapping):
        """Rebuild the work list under ``old node key -> replacement``:
        ``None`` removes the node, an existing node redirects consumers
        onto it, a fresh node takes the replaced one's place with its
        inputs resolved. Kept nodes whose inputs changed are cloned,
        never mutated."""
        if not mapping:
            return
        from ..symbol import Symbol

        orig_keys = self._keys
        rebuilt = {}
        new_nodes, present = [], set()

        def resolve_ref(ref):
            r = rebuilt.get(_key(ref))
            if r is None:
                return ref
            if ref._num_outputs > 1 and ref._output_index > 0:
                return r[ref._output_index]
            return r

        def clone_with_inputs(node, new_inputs):
            c = Symbol(op=node._op, name=node._name, inputs=new_inputs,
                       kwargs=dict(node._kwargs),
                       num_outputs=node._num_outputs)
            c._attrs.update(node._attrs)
            return c

        def add(node):
            k = _key(node)
            if k not in present:
                present.add(k)
                new_nodes.append(node)

        for node in self.nodes:
            k = _key(node)
            if k in mapping:
                rep = mapping[k]
                if rep is None:
                    continue
                if _key(rep) in orig_keys:
                    rebuilt[k] = resolve_ref(rep)
                else:
                    new_inputs = [resolve_ref(i) for i in rep._inputs]
                    if any(a is not b for a, b in zip(new_inputs,
                                                      rep._inputs)):
                        rep = clone_with_inputs(rep, new_inputs)
                    rebuilt[k] = rep
                    add(rep)
                continue
            if node._op is None:
                add(node)
                continue
            new_inputs = [resolve_ref(i) for i in node._inputs]
            if any(a is not b for a, b in zip(new_inputs, node._inputs)):
                clone = clone_with_inputs(node, new_inputs)
                rebuilt[k] = clone
                add(clone)
            else:
                add(node)

        self.heads = [resolve_ref(h) for h in self.heads]
        self.nodes = new_nodes
        self._keys = present

    def to_symbol(self):
        from ..symbol import Group

        if self.symbol._group is not None:
            return Group(self.heads)
        return self.heads[0]


def _use_counts(graph):
    counts = {}
    for n in graph.nodes:
        for i in n._inputs:
            k = _key(i)
            counts[k] = counts.get(k, 0) + 1
    return counts


def _reachable(graph):
    by_key = graph.by_key()
    live, stack = set(), list(graph.heads)
    while stack:
        s = stack.pop()
        k = _key(s)
        if k in live:
            continue
        live.add(k)
        stack.extend(by_key.get(k, s)._inputs)
    return live


# -- typed passes -----------------------------------------------------------

class AnalysisPass:
    """A named, memoized analysis; creating one installs its provider."""

    def __init__(self, name, compute, doc=""):
        self.name = name
        self.doc = doc
        register_fact(name, compute)

    def run(self, ctx):
        return ctx.fact(self.name)


class RewritePass:
    """A named graph transform: ``run(graph, ctx)`` applies a mapping to
    the work list and returns the rewrite count."""

    def __init__(self, name, fn, doc=""):
        self.name = name
        self.fn = fn
        self.doc = doc

    def run(self, graph, ctx):
        return self.fn(graph, ctx)


# -- rewrite pass bodies ----------------------------------------------------

def _fold_constants(graph, ctx):
    """Evaluate each maximal pure constant subgraph once, on the host,
    and replace its root with a ``_sym_constant`` literal."""
    import torch

    from .. import autograd
    from ..ndarray import registry as _registry
    from ..symbol import Symbol

    const = {}
    for n in graph.nodes:
        k = _key(n)
        if n._op is None:
            const[k] = False
        elif n._op in _CONST_OPS:
            const[k] = True
        elif not op_is_pure(n._op) or _registry.get_op(n._op) is None:
            const[k] = False
        else:
            const[k] = bool(n._inputs) and all(
                const.get(_key(i), False) for i in n._inputs)

    consumers = {}
    for n in graph.nodes:
        for i in n._inputs:
            consumers.setdefault(_key(i), []).append(n)
    head_keys = {_key(h) for h in graph.heads}

    mapping, eval_cache = {}, {}
    for n in graph.nodes:
        k = _key(n)
        if not const[k] or n._op in _CONST_OPS or n._num_outputs != 1:
            continue
        if k not in head_keys and all(const[_key(c)]
                                      for c in consumers.get(k, ())):
            continue  # not maximal: the root's replacement orphans it
        try:
            with torch.no_grad(), autograd.pause():
                val = n._eval_nodes({}, eval_cache)
            if isinstance(val, (list, tuple)):
                continue
            arr = val.asnumpy()
        except Exception:
            continue  # a candidate that cannot evaluate is not folded
        if arr.size > _FOLD_MAX_ELEMENTS:
            continue
        rep = Symbol(op="_sym_constant", name=n._name, inputs=[],
                     kwargs={"value": arr.tolist(),
                             "shape": tuple(int(d) for d in arr.shape),
                             "dtype": str(arr.dtype)})
        rep._attrs.update(n._attrs)
        mapping[k] = rep
    graph.apply(mapping)
    return len(mapping)


def _cse(graph, ctx):
    """Value numbering over (op, kwargs, attrs, input value numbers):
    later occurrences of a value re-point at the first. Impure ops get
    unique numbers."""
    vn, table, mapping = {}, {}, {}
    counter = 0
    for n in graph.nodes:
        k = _key(n)
        if k in vn:
            continue
        sig = None
        if n._op is None:
            sig = ("var", n._name)
        elif op_is_pure(n._op):
            try:
                sig = (n._op, repr(sorted(n._kwargs.items())),
                       repr(sorted(n._attrs.items())),
                       tuple((vn[_key(i)], i._output_index)
                             for i in n._inputs),
                       n._num_outputs)
            except KeyError:
                sig = None
        if sig is None:
            vn[k] = counter
            counter += 1
            continue
        hit = table.get(sig)
        if hit is not None:
            prev_vn, rep = hit
            vn[k] = prev_vn
            if n._op is not None and n is not rep:
                mapping[k] = rep
        else:
            vn[k] = counter
            table[sig] = (counter, n)
            counter += 1
    graph.apply(mapping)
    return len(mapping)


def _norm_axes(axes):
    if axes is None or (isinstance(axes, (list, tuple)) and not axes):
        return None
    return tuple(int(a) for a in axes)


def _plain_shape(spec, positive_only=False):
    """A reshape spec free of the positional codes 0/-2/-3/-4."""
    if not isinstance(spec, (list, tuple)) or not spec:
        return False
    try:
        dims = [int(d) for d in spec]
    except (TypeError, ValueError):
        return False
    if positive_only:
        return all(d > 0 for d in dims)
    return all(d > 0 or d == -1 for d in dims) and \
        sum(1 for d in dims if d == -1) <= 1


def _fresh_like(old, op, inputs, kwargs):
    from ..symbol import Symbol

    rep = Symbol(op=op, name=old._name, inputs=list(inputs), kwargs=kwargs)
    rep._attrs.update(old._attrs)
    return rep


def _transpose_reshape_elision(graph, ctx):
    """Identity transposes drop, transpose pairs cancel or compose,
    reshape-of-reshape collapses, identity reshapes of variables drop."""
    shapes = ctx.fact("shapes")
    var_shapes = {} if isinstance(shapes, FactError) else shapes[0]
    mapping = {}
    for n in graph.nodes:
        if n._op == "transpose" and n._inputs:
            inp = n._inputs[0]
            q = _norm_axes(n._kwargs.get("axes"))
            if q is not None and q == tuple(range(len(q))):
                mapping[_key(n)] = inp
                continue
            if inp._op != "transpose" or not inp._inputs:
                continue
            p = _norm_axes(inp._kwargs.get("axes"))
            src = inp._inputs[0]
            if p is None and q is None:
                mapping[_key(n)] = src
            elif p is not None and q is not None and len(p) == len(q):
                net = tuple(p[i] for i in q)
                mapping[_key(n)] = src if net == tuple(range(len(net))) \
                    else _fresh_like(n, "transpose", [src], {"axes": net})
        elif n._op == "reshape" and n._inputs:
            if n._kwargs.get("reverse"):
                continue
            spec = n._kwargs.get("shape")
            inp = n._inputs[0]
            if inp._op == "reshape" and inp._inputs \
                    and not inp._kwargs.get("reverse") and _plain_shape(spec):
                mapping[_key(n)] = _fresh_like(
                    n, "reshape", [inp._inputs[0]],
                    {"shape": tuple(int(d) for d in spec)})
            elif inp._op is None and _plain_shape(spec, positive_only=True):
                have = var_shapes.get(inp._name)
                if have is not None and tuple(have) == tuple(
                        int(d) for d in spec):
                    mapping[_key(n)] = inp
    graph.apply(mapping)
    return len(mapping)


def _dce(graph, ctx):
    """Drop work-list nodes no head reaches; heads always survive."""
    live = _reachable(graph)
    mapping = {k: None for k in graph._keys if k not in live}
    graph.apply(mapping)
    return len(mapping)


fold_pass = RewritePass("fold", _fold_constants,
                        "constant folding via the eager op path")
cse_pass = RewritePass("cse", _cse,
                       "purity-gated common-subexpression elimination")
transpose_elision_pass = RewritePass(
    "transpose_elision", _transpose_reshape_elision,
    "cancel/compose inverse transpose + reshape chains")
dce_pass = RewritePass("dce", _dce, "dead-node elimination from heads")

REWRITE_PASSES = {p.name: p for p in
                  (fold_pass, cse_pass, transpose_elision_pass, dce_pass)}

DEFAULT_REWRITE_PIPELINE = ("fold", "cse", "transpose_elision", "fusion",
                            "dce")


class PassManager:
    """Runs a rewrite pipeline over a ``_Graph`` once (level 1) or to a
    bounded fixpoint (level 2), recording per-pass node counts and
    wall time."""

    MAX_ITERATIONS = 5

    def __init__(self, passes=None):
        self.passes = [p if isinstance(p, RewritePass) else REWRITE_PASSES[p]
                       for p in (passes or DEFAULT_REWRITE_PIPELINE)]

    def run(self, graph, ctx, fixpoint=False):
        stats, total = [], 0
        for it in range(self.MAX_ITERATIONS if fixpoint else 1):
            iter_rewrites = 0
            for rp in self.passes:
                before = len(graph.nodes)
                t0 = time.perf_counter()
                n = rp.run(graph, ctx)
                dt_ms = (time.perf_counter() - t0) * 1e3
                stats.append({"pass": rp.name, "iteration": it,
                              "nodes_before": before,
                              "nodes_after": len(graph.nodes),
                              "rewrites": n, "time_ms": round(dt_ms, 3)})
                _count_pass(rp.name, n, dt_ms)
                iter_rewrites += n
            total += iter_rewrites
            if iter_rewrites == 0:
                break
        return total, stats


def optimize_symbol(symbol, shapes=None, dtypes=None, level=None, ctx=None,
                    subject=None, passes=None, device=None):
    """Optimize a symbol graph; returns ``(symbol, stats)``.

    ``level`` defaults to ``MXNET_GRAPH_OPT``; 0 passes the graph
    through. ``device`` is the device the graph will run on (a
    ``torch.device``, a device string or a Context; default: the
    current context): the fusion pass picks each cluster's
    implementation for it. The verifier's cheap passes run before (for
    the error baseline) and after: a new error rejects the rewrite and
    returns the original graph, or raises :class:`MXNetError` when the
    fusion pass rewrote a graph for a CUDA device."""
    lvl = opt_level() if level is None else lvl_clamp(level)
    stats = {"level": lvl, "subject": subject,
             "pipeline_version": PIPELINE_VERSION, "passes": [],
             "nodes_before": None, "nodes_after": None, "rewrites": 0,
             "rejected": False}
    if lvl <= 0:
        return symbol, stats
    _count("graphs_seen")
    if ctx is None:
        ctx = PassContext(symbol, shapes=shapes, dtypes=dtypes,
                          subject=subject)
    ctx.device = _resolve_device(device)
    if "shape" not in ctx.passes_run:
        run_passes(ctx, PRE_PASSES)
    pre_errors = len(ctx.report.errors)

    graph = _Graph(symbol)
    stats["nodes_before"] = stats["nodes_after"] = len(graph.nodes)
    total, pass_stats = PassManager(passes).run(graph, ctx,
                                                fixpoint=(lvl >= 2))
    stats["passes"] = pass_stats
    stats["rewrites"] = total
    _count("rewrites_total", total)
    if total == 0:
        return symbol, stats
    stats["nodes_after"] = len(graph.nodes)
    optimized = graph.to_symbol()

    post_ctx = PassContext(optimized, shapes=shapes, dtypes=dtypes,
                           subject=f"{subject or 'graph'}:optimized")
    run_passes(post_ctx, PRE_PASSES)
    if len(post_ctx.report.errors) > pre_errors:
        fused = any(p["pass"] == "fusion" and p["rewrites"]
                    for p in pass_stats)
        if fused and ctx.device.type == "cuda":
            # the card would quietly serve the unfused graph, kernels
            # unused: a fault, not a fallback
            raise MXNetError(
                f"graph-opt: the fused graph for {subject or symbol._name} "
                f"fails verification on {ctx.device}: "
                f"{post_ctx.report.errors[pre_errors:]}")
        logging.warning(
            "graph-opt: rejecting optimized graph for %s (%d new error "
            "diagnostic(s)); serving the original", subject or symbol._name,
            len(post_ctx.report.errors) - pre_errors)
        _count("graphs_rejected")
        stats["rejected"] = True
        stats["nodes_after"] = stats["nodes_before"]
        if fused:
            from .. import kernels

            kernels._count("fallback_post_verify")
        return symbol, stats
    _count("graphs_optimized")
    _count("nodes_before_total", stats["nodes_before"])
    _count("nodes_after_total", stats["nodes_after"])
    return optimized, stats


def _resolve_device(device):
    import torch

    from ..context import Context, current_context

    if device is None:
        device = current_context()
    if isinstance(device, Context):
        # the device named, whether or not this host has it: optimizing
        # for the card needs no card
        return torch.device("cuda" if device.device_type == "gpu" else "cpu",
                            device.device_id)
    return torch.device(device)


# register the fusion pass and its facts, then the quantize passes, into
# REWRITE_PASSES; imported last so the pass infrastructure above is
# complete
from . import fusion  # noqa: E402,F401
from . import quantize  # noqa: E402,F401
