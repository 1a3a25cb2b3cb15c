"""Int8 quantization as graph rewrite passes (reference:
src/operator/quantization/quantize_graph_pass.cc QuantizeGraph).

The PyTorch counterpart of ``mxnet_tpu/analysis/quantize.py``: three
passes that ``optimize_symbol`` schedules (``QUANTIZE_PIPELINE``), so the
int8 rewrite runs under the post-verify rejection net — a rewrite that
adds an error diagnostic is thrown away and the float32 graph served.

``quantize_insert``     wraps every quantizable op in its own int8
                        island: ``quantize_v2`` on each data input, the
                        ``_contrib_quantized_*`` op, ``requantize`` for
                        the int32-accumulating ops (conv, fully_connected,
                        batch_dot) and a trailing ``dequantize``. Conv and
                        fc weights become offline-quantized variables.
``quantize_elide``      merges adjacent islands: a ``quantize_v2`` of the
                        ``dequantize`` of a producer's (q, min, max)
                        triple re-points its consumers at the triple, so
                        int8 regions never bounce through float32 at
                        interior edges; it never fires when a consumer is
                        not quantization-aware. uint8/int8 mismatches at
                        merged edges are resolved in the op
                        (``_to_s8_lattice``).
``quantize_calibrate``  folds the calibration table into the graph: the
                        surviving boundary ``quantize_v2``,
                        ``requantize`` and quantized batch-norm nodes get
                        ``min/max_calib_range`` kwargs (auto mode moves
                        non-negative flexible boundaries to uint8), and
                        every range output known from the table is
                        re-pointed to a ``_sym_constant`` scalar.

Elide runs before calibrate, so calibration decorates only the
boundaries that survive the merge.

The per-page int8 KV-cache codes of the paged state store
(:func:`kv_page_codes`, :func:`quantize_kv_page`,
:func:`dequantize_kv_pages`) live here too, as in the JAX package. The
counters are the ``quantize`` family of the telemetry registry
(:func:`counters`). :func:`fingerprint_salt` keys the port's own caches
(the ``CachedOp`` entries and ``SymbolBlock``'s optimized graphs) by the
resolved lowering, and the ``quantize`` provider of the artifact layer
(``artifact/salts.py``) folds the same into persisted programs.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from .. import telemetry as _telemetry
from .passes import PassContext

__all__ = [
    "QUANTIZE_PIPELINE", "QUANTIZED_OPS", "QuantizeScope", "quantize_scope",
    "current_scope", "fingerprint_salt", "counters", "reset_counters",
    "kv_page_codes", "quantize_kv_page", "dequantize_kv_pages",
]

_key = PassContext.node_key

#: float32 op -> quantized-lattice op (reference: quantize_graph_pass.cc's
#: per-op NeedQuantize table)
QUANTIZED_OPS = {
    "convolution": "_contrib_quantized_conv",
    "fully_connected": "_contrib_quantized_fully_connected",
    "batch_dot": "_contrib_quantized_batch_dot",
    "pooling": "_contrib_quantized_pooling",
    "activation": "_contrib_quantized_act",
    "flatten": "_contrib_quantized_flatten",
    "elemwise_add": "_contrib_quantized_elemwise_add",
    "concat": "_contrib_quantized_concat",
    "batch_norm": "_contrib_quantized_batch_norm",
}

#: int32-accumulating quantized ops: their islands end in ``requantize``
_ACC_OPS = {"convolution", "fully_connected", "batch_dot"}

#: quantized ops whose payload is already int8/uint8 (not the int32
#: accumulators): valid elision producers
_LATTICE_OUT_OPS = {"quantize", "quantize_v2", "requantize"} | {
    v for k, v in QUANTIZED_OPS.items() if k not in _ACC_OPS}

#: ops that may consume a (q, min, max) triple: elision fires only when
#: every consumer of the quantize node is one of them
_TRIPLE_CONSUMERS = {"requantize", "dequantize"} | set(
    QUANTIZED_OPS.values())


# -- counters ---------------------------------------------------------------

_COUNTER_NAMES = ("graphs_quantized", "nodes_quantized", "islands_elided",
                  "nodes_calibrated", "scales_folded", "uint8_boundaries",
                  "weight_bytes_saved", "kv_pages_quantized")
# the ``quantize`` family of the telemetry registry
_COUNTERS = _telemetry.counter_family(
    "quantize", dict.fromkeys(_COUNTER_NAMES, 0))


def _count(name, n=1):
    _COUNTERS.add(name, n)


def counters():
    """The quantization counters: islands formed and merged, nodes
    calibrated, scale constants folded, weight bytes saved by int8
    storage, KV pages quantized."""
    return _COUNTERS.snapshot()


def reset_counters():
    _COUNTERS.reset()


# -- the scope the passes read their configuration from ----------------------

class QuantizeScope:
    """Per-run configuration and results of the quantize pipeline.

    The pass bodies are stateless functions the pass manager schedules;
    everything run-specific (exclusions, the calibration table) travels
    here. ``offline``, ``meta`` and ``islands`` are OUTPUTS that
    ``contrib.quantization`` reads after ``optimize_symbol``."""

    def __init__(self, excluded_sym_names=(), excluded_op_names=(),
                 calib_ranges=None, auto_dtype=False):
        self.excluded_sym_names = set(excluded_sym_names)
        self.excluded_op_names = set(excluded_op_names)
        self.calib_ranges = dict(calib_ranges or {})
        self.auto_dtype = bool(auto_dtype)
        #: weight var -> (quantized_name, min_name, max_name) variables
        #: the caller fills (reference: offline_params)
        self.offline = {}
        #: node name -> {"src": tensor name, "flex": bool} for the nodes
        #: the insertion made; keyed by NAME, which rewrites keep
        self.meta = {}
        #: int8 islands the insertion formed
        self.islands = 0


_tls = threading.local()


def current_scope():
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def quantize_scope(**kwargs):
    scope = QuantizeScope(**kwargs)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(scope)
    try:
        yield scope
    finally:
        stack.pop()


# -- helpers ----------------------------------------------------------------

def _out_name(s):
    outs = s.list_outputs()
    return outs[s._output_index if s._num_outputs > 1 else 0]


def _view(base, ref):
    """``base`` at ``ref``'s output index (itself for single-output
    nodes and index 0)."""
    if ref._num_outputs > 1 and ref._output_index > 0:
        return base[ref._output_index]
    return base


def _rebuild(graph, new_heads):
    """Rebuild the work list from fresh heads: the insertion makes
    chains (quantize -> op -> requantize -> dequantize) whose interior
    nodes ``_Graph.apply`` would not enlist."""
    from ..symbol import Group

    graph.heads = list(new_heads)
    graph.nodes = []
    graph._keys = set()
    for s in Group(new_heads)._walk():
        if s._group is not None:
            continue
        k = _key(s)
        if k not in graph._keys:
            graph._keys.add(k)
            graph.nodes.append(s)


def _quantizable(node, scope):
    if node._op not in QUANTIZED_OPS:
        return False
    if (node._name or "") in scope.excluded_sym_names:
        return False
    if node._op in scope.excluded_op_names:
        return False
    kw = node._kwargs
    if node._op == "activation" and kw.get("act_type") != "relu":
        return False
    if node._op == "pooling" and kw.get("pool_type", "max") not in (
            "max", "avg"):
        return False
    if node._op == "batch_norm" and (
            kw.get("output_mean_var") or kw.get("axis", 1) != 1):
        return False  # the quantized batch norm is wired for axis 1
    if node._op in ("convolution", "fully_connected") and \
            node._inputs[1]._op is not None:
        return False  # a computed weight cannot be quantized offline
    return True


# -- pass 1: insertion -------------------------------------------------------

def _quantize_insert(graph, ctx):
    """Wrap each quantizable op in its own int8 island; merging the
    islands is ``quantize_elide``'s job."""
    scope = current_scope()
    if scope is None:
        return 0
    from ..symbol import Symbol, _make_node, var as _svar

    rep = {}     # original base key -> new float32 base node
    qmemo = {}   # (input base key, output index, req) -> (q, mn, mx)
    created = 0

    def fp32_of(ref):
        base = rep.get(_key(ref))
        if base is None or base is ref:
            return ref
        return _view(base, ref)

    def as_q(ref, req):
        nonlocal created
        idx = ref._output_index if ref._num_outputs > 1 else 0
        mkey = (_key(ref), idx, req)
        hit = qmemo.get(mkey)
        if hit is not None:
            return hit
        name = (ref._name or "t") + f"_quantize_{req}{idx}"
        n = _make_node("quantize_v2", [fp32_of(ref)], {"out_type": "int8"},
                       name=name)
        scope.meta[name] = {"src": _out_name(ref), "flex": req != "int8"}
        created += 1
        triple = (n[0], n[1], n[2])
        qmemo[mkey] = triple
        return triple

    def weight_vars(wnode):
        """The offline-quantized weight: three fresh variables the caller
        fills from the float32 parameters; tied weights share them."""
        wname = wnode._name
        if wname not in scope.offline:
            scope.offline[wname] = (wname + "_quantized", wname + "_min",
                                    wname + "_max")
        qn, mnn, mxn = scope.offline[wname]
        return _svar(qn), _svar(mnn), _svar(mxn)

    islands = 0
    for node in list(graph.nodes):
        k = _key(node)
        if node._op is None:
            rep[k] = node
            continue
        if not _quantizable(node, scope):
            ins = [fp32_of(i) for i in node._inputs]
            if all(a is b for a, b in zip(ins, node._inputs)):
                rep[k] = node
            else:
                newn = Symbol(op=node._op, name=node._name, inputs=ins,
                              kwargs=dict(node._kwargs),
                              num_outputs=node._num_outputs)
                newn._attrs.update(node._attrs)
                rep[k] = newn
            continue
        op, name, kw = node._op, node._name, dict(node._kwargs)
        if op in ("convolution", "fully_connected"):
            dq, dmn, dmx = as_q(node._inputs[0], "int8")
            wq, wmn, wmx = weight_vars(node._inputs[1])
            ins = [dq, wq, dmn, dmx, wmn, wmx]
            if len(node._inputs) > 2 and not kw.get("no_bias"):
                ins.append(fp32_of(node._inputs[2]))
            qn = _make_node(QUANTIZED_OPS[op], ins, kw,
                            name="quantized_" + name)
        elif op == "batch_dot":
            lq, lmn, lmx = as_q(node._inputs[0], "int8")
            rq, rmn, rmx = as_q(node._inputs[1], "int8")
            qn = _make_node(QUANTIZED_OPS[op], [lq, rq, lmn, lmx, rmn, rmx],
                            kw, name="quantized_" + name)
        elif op == "batch_norm":
            dq, dmn, dmx = as_q(node._inputs[0], "any")
            gamma, beta, mean, var_ = (fp32_of(i) for i in node._inputs[1:5])
            bkw = {"eps": kw.get("eps", 1e-3),
                   "fix_gamma": kw.get("fix_gamma", True)}
            qn = _make_node(QUANTIZED_OPS[op],
                            [dq, gamma, beta, mean, var_, dmn, dmx], bkw,
                            name="quantized_" + name)
            scope.meta["quantized_" + name] = {"src": _out_name(node),
                                               "flex": False}
        elif op == "elemwise_add":
            lq, lmn, lmx = as_q(node._inputs[0], "any")
            rq, rmn, rmx = as_q(node._inputs[1], "any")
            qn = _make_node(QUANTIZED_OPS[op], [lq, rq, lmn, lmx, rmn, rmx],
                            {}, name="quantized_" + name)
        elif op == "concat":
            qs = [as_q(i, "any") for i in node._inputs]
            ins = [q for q, _, _ in qs] + [mn for _, mn, _ in qs] + \
                [mx_ for _, _, mx_ in qs]
            qn = _make_node(QUANTIZED_OPS[op], ins, {"dim": kw.get("dim", 1)},
                            name="quantized_" + name)
        else:  # pooling / activation / flatten: data and range through
            dq, dmn, dmx = as_q(node._inputs[0], "any")
            qn = _make_node(QUANTIZED_OPS[op], [dq, dmn, dmx], kw,
                            name="quantized_" + name)
        if op in _ACC_OPS:
            rq_ = _make_node("requantize", [qn[0], qn[1], qn[2]],
                             {"out_type": "int8"}, name=name + "_requantize")
            scope.meta[name + "_requantize"] = {"src": _out_name(node),
                                                "flex": False}
            qn = rq_
        deq = _make_node("dequantize", [qn[0], qn[1], qn[2]], {},
                         name=name + "_dequantize")
        rep[k] = deq
        islands += 1
        created += 1

    scope.islands = islands
    if islands == 0:
        return 0
    _rebuild(graph, [fp32_of(h) for h in graph.heads])
    _count("graphs_quantized")
    _count("nodes_quantized", islands)
    return created


# -- pass 2: dequantize -> quantize elision -----------------------------------

def _quantize_elide(graph, ctx):
    """Merge adjacent int8 islands: ``quantize_v2(dequantize(q, mn, mx))``
    over the 0/1/2 outputs of one lattice-output producer re-points its
    consumers at the producer's triple. The dequantize survives if a
    float32 op still reads it; the rewrite never fires when the quantize
    node has a consumer that is not quantization-aware."""
    consumers = {}
    for n in graph.nodes:
        for i in n._inputs:
            consumers.setdefault(_key(i), []).append(n)
    head_keys = {_key(h) for h in graph.heads}

    mapping = {}
    for n in graph.nodes:
        if n._op not in ("quantize_v2", "quantize"):
            continue
        k = _key(n)
        if k in head_keys:
            continue
        d = n._inputs[0]
        if d._op != "dequantize" or len(d._inputs) != 3:
            continue
        q, mn, mx_ = d._inputs
        if q._op not in _LATTICE_OUT_OPS:
            continue
        if not (_key(q) == _key(mn) == _key(mx_)):
            continue  # the ranges come from elsewhere: not a pure pair
        if (q._output_index, mn._output_index, mx_._output_index) != \
                (0, 1, 2):
            continue
        if any(c._op not in _TRIPLE_CONSUMERS
               for c in consumers.get(k, ())):
            continue  # a float32 consumer reads this node: keep it
        mapping[k] = q
    graph.apply(mapping)
    _count("islands_elided", len(mapping))
    return len(mapping)


# -- pass 3: calibration folding ---------------------------------------------

def _calib_const(node_name, idx, value, const_memo):
    from ..symbol import Symbol

    ck = (node_name, idx)
    sym = const_memo.get(ck)
    if sym is None:
        sym = Symbol(op="_sym_constant", name=f"{node_name}_calib{idx}",
                     kwargs={"value": float(value), "shape": (1,),
                             "dtype": "float32"})
        const_memo[ck] = sym
    return sym


def _quantize_calibrate(graph, ctx):
    """Fold the calibration table into the graph: boundary nodes gain
    ``min/max_calib_range`` (auto mode moves non-negative flexible
    boundaries to uint8), then every statically known range output is
    replaced by a ``_sym_constant`` scalar in its consumers."""
    scope = current_scope()
    if scope is None:
        return 0
    from ..symbol import Symbol

    mapping = {}
    calibrated = 0
    for n in graph.nodes:
        meta = scope.meta.get(n._name or "")
        if meta is None or n._op not in (
                "quantize_v2", "requantize", "_contrib_quantized_batch_norm"):
            continue
        rng = scope.calib_ranges.get(meta["src"])
        if rng is None:
            continue
        kw = dict(n._kwargs)
        kw["min_calib_range"] = float(rng[0])
        kw["max_calib_range"] = float(rng[1])
        if n._op == "quantize_v2" and meta["flex"] and \
                scope.auto_dtype and float(rng[0]) >= 0.0:
            # the reference's 'auto' mode: non-negative (post-relu)
            # boundaries take the uint8 lattice's extra bit
            kw["out_type"] = "uint8"
            _count("uint8_boundaries")
        rep = Symbol(op=n._op, name=n._name, inputs=list(n._inputs),
                     kwargs=kw, num_outputs=n._num_outputs)
        rep._attrs.update(n._attrs)
        mapping[_key(n)] = rep
        calibrated += 1
    graph.apply(mapping)
    _count("nodes_calibrated", calibrated)

    # the calibrated nodes' range outputs are static now: int8 lattices
    # carry (-amax, +amax), uint8 ones (0, max)
    static = {}  # producer key -> (min value, max value)
    for n in graph.nodes:
        if n._op not in ("quantize_v2", "requantize",
                         "_contrib_quantized_batch_norm"):
            continue
        kw = n._kwargs
        if kw.get("min_calib_range") is None or \
                kw.get("max_calib_range") is None:
            continue
        cmn = float(kw["min_calib_range"])
        cmx = float(kw["max_calib_range"])
        if n._op == "quantize_v2" and kw.get("out_type") == "uint8":
            static[_key(n)] = (0.0, cmx)
        else:
            amax = max(abs(cmn), abs(cmx))
            static[_key(n)] = (-amax, amax)
    if not static:
        return calibrated

    by_key = {}
    for n in graph.nodes:
        by_key.setdefault(_key(n), n)
    head_keys = {_key(h) for h in graph.heads}
    const_memo = {}
    folded = {}
    for n in graph.nodes:
        if _key(n) in head_keys and n._op is None:
            continue
        new_inputs, changed = [], False
        for i in n._inputs:
            vals = static.get(_key(i))
            if vals is not None and i._output_index in (1, 2):
                prod = by_key[_key(i)]
                new_inputs.append(_calib_const(
                    prod._name or "q", i._output_index,
                    vals[i._output_index - 1], const_memo))
                changed = True
            else:
                new_inputs.append(i)
        if changed:
            rep = Symbol(op=n._op, name=n._name, inputs=new_inputs,
                         kwargs=dict(n._kwargs), num_outputs=n._num_outputs)
            rep._attrs.update(n._attrs)
            folded[_key(n)] = rep
    graph.apply(folded)
    # apply() enlists only a replacement's direct nodes: make the shared
    # constants work-list members so cse and dce see them
    for sym in const_memo.values():
        ck = _key(sym)
        if ck not in graph._keys:
            graph._keys.add(ck)
            graph.nodes.insert(0, sym)
    _count("scales_folded", len(const_memo))
    return calibrated + len(folded)


#: scheduled through ``optimize_symbol(..., passes=QUANTIZE_PIPELINE)``:
#: the rewrite runs under the post-verify rejection net, and fold, cse and
#: dce clean up the orphaned float32 islands and duplicate boundaries
QUANTIZE_PIPELINE = ("quantize_insert", "quantize_elide",
                     "quantize_calibrate", "fold", "cse", "dce")


# -- int8 KV pages -------------------------------------------------------------

def kv_page_codes(pages):
    """The arithmetic of :func:`quantize_kv_page` without its counter:
    ``pages`` (n, ...) float32 -> (int8 codes, float32 per-page scales
    (n,)). Device ops only, no host sync, so it can run inside a
    captured graph; a caller bumps ``kv_pages_quantized`` itself."""
    red = tuple(range(1, pages.dim()))
    amax = pages.abs().amax(dim=red)
    scale = amax / torch.full_like(amax, 127.0)
    denom = torch.where(scale > 0, scale, torch.ones_like(scale))
    shape = tuple(scale.shape) + (1,) * (pages.dim() - 1)
    q = torch.clamp(torch.round(pages / denom.reshape(shape)), -127,
                    127).to(torch.int8)
    return q, scale


def quantize_kv_page(pages):
    """Symmetric per-page int8 quantization of paged KV storage: a
    batch-first float32 block ``(n, ...)`` -> ``(int8 codes, float32
    scales (n,))``. Zero-point-free, so a page of zeros round-trips to
    exact zeros and the attention mask's guarantees survive."""
    q, scale = kv_page_codes(pages)
    _count("kv_pages_quantized", int(pages.shape[0]))
    return q, scale


def dequantize_kv_pages(q, scales, out=None):
    """Inverse of :func:`quantize_kv_page`, the per-page scales
    broadcast over the trailing axes (``q`` may carry extra leading axes
    that ``scales`` matches); written into ``out`` when given."""
    shape = tuple(scales.shape) + (1,) * (q.dim() - scales.dim())
    return torch.mul(q.to(torch.float32), scales.reshape(shape), out=out)


# -- the cache-key salt -------------------------------------------------------

def graph_has_quantized_ops(symbol):
    """Whether ``symbol`` runs quantized-lattice ops."""
    return any((s._op or "").startswith("_contrib_quantized_")
               for s in symbol._walk())


def fingerprint_salt(quantized, like=None):
    """Cache-key element of a graph or block that runs quantized ops
    (``quantized`` true): its lowering, resolved for the device of
    ``like`` (``MXNET_QUANTIZE_LOWERING``), so a capture made under one
    lowering is never replayed under another. float32 graphs add nothing,
    which keeps every other key as it was."""
    if not quantized:
        return ()
    from ..ndarray.ops_quant import lowering

    return ("quantize", lowering(like))


def _register():
    from .graph_opt import REWRITE_PASSES, RewritePass

    REWRITE_PASSES["quantize_insert"] = RewritePass(
        "quantize_insert", _quantize_insert,
        "wrap quantizable ops in per-node int8 islands")
    REWRITE_PASSES["quantize_elide"] = RewritePass(
        "quantize_elide", _quantize_elide,
        "merge adjacent int8 islands (dequant->quant pair elision)")
    REWRITE_PASSES["quantize_calibrate"] = RewritePass(
        "quantize_calibrate", _quantize_calibrate,
        "fold calibration statistics into kwargs + constant scales")


_register()


# -- artifact-layer salt provider -------------------------------------------

def _salt_provider(ctx):
    """The ``quantize`` contribution to a program's fingerprint: the
    lowering resolved for ``ctx["device"]`` when ``ctx["graph_signature"]``
    holds quantized ops, else nothing (float32 keys stay as they were)."""
    sig = ctx.get("graph_signature")
    if sig is None or "_contrib_quantized_" not in sig:
        return ()
    from ..ndarray.ops_quant import lowering

    return ("quantize", lowering(ctx.get("device")))


from ..artifact import salts as _artifact_salts  # noqa: E402

_artifact_salts.register_salt_provider("quantize", _salt_provider)
