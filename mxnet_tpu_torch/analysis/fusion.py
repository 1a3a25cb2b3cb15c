"""Fusion clustering: group fusable subgraphs into fused kernel ops.

The PyTorch counterpart of ``mxnet_tpu/analysis/fusion.py``, matching
the same three cluster kinds over the ``_Graph`` work list:

- **elementwise** — maximal chains and trees of pure, single-consumer
  elementwise ops (``kernels.elementwise.ELEMENTWISE_OPS``);
- **norm_act** — ``layer_norm`` feeding one activation node
  (BatchNorm→act is matched and always rejected as effectful, counted
  as ``fallback_effectful``);
- **attention** — ``batch_dot(softmax(batch_dot(q, k, T) [*/ scale]),
  v)``.

Each profitable cluster becomes ONE fused op from ``mxnet_tpu_torch.
kernels``. Whether to fuse, and with which implementation, is
``kernels.cost_model.decide``'s call per cluster: ``cuda`` (the
hand-written kernel) when the graph runs on a CUDA device and the
kernel takes the cluster's shape and dtype, ``torch`` (the replay of
the member ops) otherwise. Where the JAX pass reads
``jax.default_backend()``, this one reads the device the graph is
optimized for (``optimize_symbol(device=)``). Rejected candidates keep
their 1:1 lowering, and the reason lands in the fusion counters.
"""
from __future__ import annotations

from ..base import MXNetError
from .graph_opt import (REWRITE_PASSES, AnalysisPass, RewritePass,
                        _fresh_like, _key, _use_counts, op_is_pure)
from .passes import FactError

#: defaults that resolve a matched activation node's act_type
_ACT_DEFAULTS = {"activation": "relu", "leaky_relu": "leaky"}

_SCALE_OPS = {"broadcast_mul_scalar": "mul", "broadcast_div_scalar": "div"}


class _Unfreezable(Exception):
    pass


def _freeze(v):
    """Kwarg value -> hashable form (tuples for lists)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    try:
        hash(v)
    except TypeError:
        raise _Unfreezable from None
    return v


def _frozen_kwargs(node):
    """``node._kwargs`` as a sorted items tuple, or None when a value
    resists freezing (such a node is never absorbed)."""
    try:
        return tuple((k, _freeze(v)) for k, v in sorted(node._kwargs.items()))
    except _Unfreezable:
        return None


def _classify(node):
    """The pattern roles of one node, or None."""
    from ..kernels.elementwise import ELEMENTWISE_OPS
    from ..kernels.norm_act import FUSABLE_ACTS

    op = node._op
    if op is None or node._num_outputs != 1 or not op_is_pure(op):
        return "bn_act_candidate" if op == "batch_norm" else None
    roles = []
    if op in ELEMENTWISE_OPS:
        roles.append("elementwise")
    if op in FUSABLE_ACTS:
        eff = node._kwargs.get("act_type", _ACT_DEFAULTS.get(op))
        if eff in FUSABLE_ACTS[op]:
            roles.append("act")
    if op == "layer_norm" and not node._kwargs.get("output_mean_var"):
        roles.append("norm")
    if op == "batch_dot":
        roles.append("batch_dot")
    if op == "softmax":
        roles.append("softmax")
    if op in _SCALE_OPS and not node._kwargs.get("reverse"):
        roles.append("scale")
    return tuple(roles) or None


def _fusion_patterns_fact(ctx):
    return {_key(n): _classify(n) for n in ctx.nodes()}


def _node_tables(symbol, ctx):
    """``(node key -> output shape, node key -> output dtype)`` of the
    nodes of ``symbol`` from one inference walk over the context's known
    shapes and dtypes; unknown entries are absent. Raises what inference
    raises."""
    from ..symbol.infer import infer_shapes

    _, _, node_out, node_dt = infer_shapes(
        symbol, ctx.known(), allow_unknown=True, return_node_shapes=True,
        dtypes=ctx.known_dtypes)
    shapes, dtypes = {}, {}
    for n in symbol._walk():
        if id(n) in node_out:
            shapes[_key(n)] = node_out[id(n)]
            dtypes[_key(n)] = node_dt[id(n)]
    return shapes, dtypes


def _node_shapes_fact(ctx):
    """The original graph's :func:`_node_tables`, or a FactError. (The
    JAX fact holds the shapes alone: the port's cost model also needs
    the dtype a kernel would take.)"""
    try:
        return _node_tables(ctx.symbol, ctx)
    except Exception:
        return FactError("node shape inference failed")


fusion_pattern_analysis = AnalysisPass(
    "fusion_patterns", _fusion_patterns_fact,
    "node key -> fusion pattern roles")
node_shape_analysis = AnalysisPass(
    "node_shapes", _node_shapes_fact,
    "(node key -> inferred output shape, -> dtype) for the cost model")


def _roles(node, fact):
    k = _key(node)
    if k in fact:
        return fact[k] or ()
    return _classify(node) or ()  # a node an earlier rewrite made


def _lookup(node, table):
    if isinstance(table, (FactError, type(None))):
        return None
    s = table.get(_key(node))
    if isinstance(s, list):
        s = s[node._output_index] if node._output_index < len(s) else None
    return s


def _plain_softmax(node):
    """Softmax over the last axis without masking, temperature or an
    output dtype (those change the replay contract)."""
    kw = node._kwargs
    return (len(node._inputs) == 1 and kw.get("axis", -1) == -1
            and not kw.get("use_length")
            and kw.get("temperature") in (None, 1.0)
            and kw.get("dtype") is None)


def _cluster_tables(graph, ctx, on_cuda):
    """``(shapes, dtypes, why)`` for the cost model. Off CUDA: the
    memoized fact over the original graph, as the JAX pass reads it (a
    node an earlier rewrite made has no entry). On CUDA, where a
    cluster's shape picks its kernel, a fresh walk over the current
    work list, so cloned nodes keep their shapes; ``why`` holds the
    inference error when that walk fails."""
    if not on_cuda:
        tables = ctx.fact("node_shapes")
        if isinstance(tables, FactError):
            return None, None, tables.message
        return tables + (None,)
    try:
        return _node_tables(graph.to_symbol(), ctx) + (None,)
    except Exception as e:  # surfaced by the first cluster that needs it
        return None, None, f"{type(e).__name__}: {e}"


def _fusion(graph, ctx):
    """The clustering rewrite: match, ask the cost model, replace. On a
    CUDA device a cluster whose shape is unknown raises
    :class:`MXNetError` instead of falling back to the replay: every
    input and parameter shape is known there, so an unknown shape means
    inference broke."""
    import torch

    from .. import kernels
    from ..kernels import cost_model

    if not kernels.fusion_enabled():
        kernels._count("pass_skipped_disabled")
        return 0
    patterns = kernels.enabled_patterns()
    mode = kernels.cost_model_mode()
    device = getattr(ctx, "device", None)
    on_cuda = device is not None and torch.device(device).type == "cuda"
    fact = ctx.fact("fusion_patterns")
    shapes, dtypes, tables_error = _cluster_tables(graph, ctx, on_cuda)
    use_counts = _use_counts(graph)
    head_keys = {_key(h) for h in graph.heads}
    order = {_key(n): i for i, n in enumerate(graph.nodes)}

    consumed = set()
    mapping = {}
    clusters = 0

    def interior_ok(node):
        """May ``node`` be absorbed as a cluster interior?"""
        k = _key(node)
        return (k in order and k not in consumed and k not in head_keys
                and use_counts.get(k, 0) == 1 and node._num_outputs == 1
                and node._output_index == 0)

    def decide(pattern, members, root, operands=(), score_shape=None,
               **kernel_args):
        d = cost_model.decide(pattern, len(members),
                              out_shape=_lookup(root, shapes),
                              device=device, mode=mode,
                              score_shape=score_shape,
                              dtype=_lookup(root, dtypes),
                              operands=[(_lookup(o, shapes),
                                         _lookup(o, dtypes))
                                        for o in operands], **kernel_args)
        if d.fuse and d.reason == "shape_unknown":
            raise MXNetError(
                f"fusion for {device}: the {pattern} cluster at "
                f"'{root._name}' has an unknown shape or dtype, so no "
                "kernel can be chosen for it "
                f"({tables_error or 'pass every input shape'})")
        if d.fuse:
            kernels._count(f"clusters_{pattern}")
            kernels._count(f"impl_{d.impl}")
            kernels._count("nodes_absorbed", len(members) - 1)
            if d.reason != "ok":  # on a CUDA device, a kernel refused
                kernels._count(f"replay_{d.reason}")
        else:
            kernels._count(f"fallback_{d.reason}")
        return d

    def claim(members, root_key, fused):
        nonlocal clusters
        consumed.update(_key(m) for m in members)
        mapping[root_key] = fused
        clusters += 1

    # -- attention: most specific first -----------------------------------
    if "attention" in patterns:
        for n in reversed(graph.nodes):
            k = _key(n)
            if k in consumed or "batch_dot" not in _roles(n, fact):
                continue
            if n._kwargs.get("transpose_a") or \
                    n._kwargs.get("transpose_b") or len(n._inputs) != 2:
                continue
            p, v = n._inputs
            if "softmax" not in _roles(p, fact) or not interior_ok(p) \
                    or not _plain_softmax(p):
                continue
            s = p._inputs[0]
            scale_op, scale = "none", 1.0
            if s._op in _SCALE_OPS and interior_ok(s) \
                    and "scale" in _roles(s, fact):
                scale_op = _SCALE_OPS[s._op]
                scale = float(s._kwargs.get("scalar", 0.0))
                score = s._inputs[0]
            else:
                s, score = None, s
            if "batch_dot" not in _roles(score, fact) \
                    or not interior_ok(score):
                continue
            if score._kwargs.get("transpose_a") \
                    or not score._kwargs.get("transpose_b") \
                    or len(score._inputs) != 2:
                continue
            members = [score, p, n] + ([s] if s is not None else [])
            softmax_kw = _frozen_kwargs(p)
            if softmax_kw is None:
                continue
            q, kk = score._inputs
            d = decide("attention", members, n, operands=(q, kk, v),
                       score_shape=_lookup(score, shapes))
            if not d.fuse:
                continue
            claim(members, k, _fresh_like(n, "_fused_attention", [q, kk, v],
                                          {"scale_op": scale_op,
                                           "scale": scale,
                                           "softmax_kw": softmax_kw,
                                           "impl": d.impl}))

    # -- norm + activation ------------------------------------------------
    if "norm_act" in patterns:
        for n in reversed(graph.nodes):
            k = _key(n)
            if k in consumed or "act" not in _roles(n, fact):
                continue
            if len(n._inputs) != 1:
                continue  # prelu-style parameterized acts stay out
            ln = n._inputs[0]
            if "bn_act_candidate" in _roles(ln, fact):
                kernels._count("fallback_effectful")
                continue
            if "norm" not in _roles(ln, fact) or not interior_ok(ln):
                continue
            if len(ln._inputs) != 3:
                continue
            members = [ln, n]
            norm_kw = _frozen_kwargs(ln)
            act_kw = _frozen_kwargs(n)
            if norm_kw is None or act_kw is None:
                continue
            d = decide("norm_act", members, n, operands=ln._inputs,
                       norm_axis=dict(norm_kw).get("axis", -1))
            if not d.fuse:
                continue
            claim(members, k, _fresh_like(n, "_fused_norm_act",
                                          list(ln._inputs),
                                          {"norm_kw": norm_kw,
                                           "act_op": n._op,
                                           "act_kw": act_kw,
                                           "impl": d.impl}))

    # -- elementwise chains and trees -------------------------------------
    if "elementwise" in patterns:
        for n in reversed(graph.nodes):
            k = _key(n)
            if k in consumed or "elementwise" not in _roles(n, fact):
                continue
            if _frozen_kwargs(n) is None:
                continue
            members, frontier = [n], list(n._inputs)
            member_keys = {k}
            while frontier:
                cand = frontier.pop()
                ck = _key(cand)
                if ck in member_keys:
                    continue
                if "elementwise" in _roles(cand, fact) \
                        and interior_ok(cand) \
                        and _frozen_kwargs(cand) is not None:
                    member_keys.add(ck)
                    members.append(cand)
                    frontier.extend(cand._inputs)
            if len(members) < 2:
                kernels._count("fallback_too_small")
                continue
            d = decide("elementwise", members, n)
            if not d.fuse:
                continue
            fused = _build_elementwise(members, member_keys, n, order)
            if fused is None:
                continue
            claim(members, k, fused)

    graph.apply(mapping)
    return clusters


def _build_elementwise(members, member_keys, root, order):
    """The ``_fused_elementwise`` node of one chain or tree: members in
    topological order, external inputs in first-seen order, each member
    a ``(op, arg_slots, kw_items)`` step over the slot file."""
    members = sorted(members, key=lambda m: order.get(_key(m), 1 << 30))
    ext, ext_slot = [], {}
    member_slot = {}
    steps = []
    for m in members:
        arg_slots = []
        for i in m._inputs:
            ik = _key(i)
            if ik in member_keys and i._output_index == 0:
                arg_slots.append(("m", ik))
            else:
                ek = (ik, i._output_index)
                if ek not in ext_slot:
                    ext_slot[ek] = len(ext)
                    ext.append(i)
                arg_slots.append(("e", ext_slot[ek]))
        steps.append((m, arg_slots))
    n_ext = len(ext)
    program = []
    for j, (m, arg_slots) in enumerate(steps):
        resolved = []
        for tag, val in arg_slots:
            if tag == "m":
                if val not in member_slot:
                    return None  # a member used before it is computed
                resolved.append(member_slot[val])
            else:
                resolved.append(val)
        program.append((m._op, tuple(resolved), _frozen_kwargs(m)))
        member_slot[_key(m)] = n_ext + j
    return _fresh_like(root, "_fused_elementwise", ext,
                       {"program": tuple(program)})


fusion_pass = RewritePass(
    "fusion", _fusion,
    "cluster fusable subgraphs into kernels-package fused ops")
REWRITE_PASSES["fusion"] = fusion_pass
