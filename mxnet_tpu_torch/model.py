"""Checkpoints of symbolic models.

The PyTorch counterpart of ``mxnet_tpu/model.py`` (reference:
python/mxnet/model.py:394-442 save_checkpoint/load_checkpoint):
``prefix-symbol.json`` (the graph's nnvm JSON) and
``prefix-NNNN.params`` (``arg:``/``aux:``-prefixed arrays in the
reference's binary format). ``nd.save`` writes the bytes the JAX package
writes for the same arrays, so a checkpoint either package saves loads
in the other.
"""
from __future__ import annotations

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write the symbol JSON (when ``symbol`` is given) and the
    parameters of ``epoch`` (reference: model.py:394)."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in arg_params.items()}
    payload.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", payload)


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays on
    ``ctx`` (default: the current context) (reference: model.py
    load_checkpoint)."""
    from . import symbol as sym

    symbol = sym.load(f"{prefix}-symbol.json")
    loaded = nd.load(f"{prefix}-{epoch:04d}.params", ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tag, name = k.split(":", 1)
        if tag == "arg":
            arg_params[name] = v
        elif tag == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
