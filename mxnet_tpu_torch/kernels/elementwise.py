"""Fused elementwise-chain cluster op.

The PyTorch counterpart of ``mxnet_tpu/kernels/elementwise.py``. The
cluster op replays the member ops' registered bodies, body for body, in
one call: the same torch ops in the same order, so its results are
bit-identical to the unfused chain. (The JAX package has no Pallas
kernel here either; the one dispatch its replay saves is XLA's.)

The program rides in the ``program`` kwarg: a tuple of
``(opname, arg_slots, kw_items)`` steps over a slot file whose first
``len(data)`` slots are the cluster inputs; each step appends one slot,
and the last slot is the cluster output.
"""
from __future__ import annotations

from ..ndarray.registry import get_op, register

#: ops the clustering pass may absorb into an elementwise chain (the JAX
#: package's set, ``elementwise.py:23-42``)
ELEMENTWISE_OPS = frozenset({
    "relu", "sigmoid", "hard_sigmoid", "softsign", "rsqrt", "rcbrt",
    "exp", "expm1", "log", "log1p", "log2", "log10", "sqrt", "cbrt",
    "square", "abs", "sign", "negative", "reciprocal", "erf", "erfinv",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "tanh", "arcsinh", "arccosh", "arctanh", "floor", "ceil", "round",
    "rint", "trunc", "fix", "gamma", "gammaln", "clip",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_power", "broadcast_maximum", "broadcast_minimum",
    "broadcast_hypot", "elemwise_add", "elemwise_sub", "elemwise_mul",
    "elemwise_div", "maximum", "minimum", "hypot", "add_n",
    "broadcast_add_scalar", "broadcast_sub_scalar",
    "broadcast_mul_scalar", "broadcast_div_scalar",
    "broadcast_power_scalar", "maximum_scalar", "minimum_scalar",
    "activation", "leaky_relu",
})


def run_program(program, slots):
    """Replay ``program`` over the slot file."""
    for opname, arg_slots, kw_items in program:
        opdef = get_op(opname)
        if opdef is None:
            raise ValueError(f"fused elementwise program references "
                             f"unregistered op {opname!r}")
        slots.append(opdef.fn(*[slots[i] for i in arg_slots],
                              **dict(kw_items)))
    return slots[-1]


@register("_fused_elementwise", namespaces=())
def _fused_elementwise(*data, program=()):
    """Fused elementwise cluster: replay ``program`` over the slot file
    seeded with ``data``; bit-identical to the unfused chain."""
    return run_program(program, list(data))
