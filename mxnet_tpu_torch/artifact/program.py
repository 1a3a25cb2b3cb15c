"""The port's program payload: a symbol graph as lossless JSON.

The nnvm JSON that ``Symbol.tojson`` writes is the reference's exchange
format, and it stringifies every attribute ("(3, 3)", a float's
``str``, a literal array's truncated repr). A persisted program must
come back as the very graph that was optimized, down to each fused
node's implementation, each folded constant and each calibrated range,
so this module writes its own form: one record per node (op, name,
inputs as (node, output) pairs, kwargs through
``compile_cache.encode_value``, attributes, output count) and the
heads. Nodes are identified as the graph optimizer identifies them
(``PassContext.node_key``), so output views of one node stay one node.
A kwarg that ``encode_value`` cannot carry makes the program
unpersistable (``compile_cache._Unstable``): its caller stays
memory-only.
"""
from __future__ import annotations

from ..utils import compile_cache as _cc

__all__ = ["PROGRAM_VERSION", "encode_symbol", "decode_symbol"]

PROGRAM_VERSION = 1


def _node_key(s):
    if s._op is None:
        return ("var", s._name)
    return (s._op, id(s._inputs), id(s._kwargs))


def encode_symbol(sym):
    """The JSON-able program of ``sym`` (a Symbol or a Group)."""
    order, index = [], {}
    for s in sym._walk():
        if s._group:
            continue
        k = _node_key(s)
        if k not in index:
            index[k] = len(order)
            order.append(s)

    def ref(s):
        return [index[_node_key(s)], int(s._output_index)]

    nodes = [{"op": s._op, "name": s._name,
              "inputs": [ref(i) for i in s._inputs],
              "kwargs": _cc.encode_value(dict(s._kwargs)),
              "attrs": dict(s._attrs),
              "num_outputs": int(s._num_outputs)} for s in order]
    heads = sym._group if sym._group else [sym]
    return {"version": PROGRAM_VERSION, "nodes": nodes,
            "heads": [ref(h) for h in heads], "group": bool(sym._group)}


def decode_symbol(program):
    """The Symbol (or Group) :func:`encode_symbol` wrote."""
    from ..symbol import Group, Symbol

    if not isinstance(program, dict) or \
            program.get("version") != PROGRAM_VERSION:
        raise ValueError("not a program of this version")
    built = []

    def view(i, oi):
        return built[i] if oi == 0 else built[i][oi]

    for n in program["nodes"]:
        node = Symbol(op=n["op"], name=n["name"],
                      inputs=[view(i, oi) for i, oi in n["inputs"]],
                      kwargs=_cc.decode_value(n["kwargs"]),
                      num_outputs=int(n["num_outputs"]))
        node._attrs.update(n.get("attrs") or {})
        built.append(node)
    heads = [view(i, oi) for i, oi in program["heads"]]
    if program.get("group"):
        return Group(heads)
    return heads[0]
