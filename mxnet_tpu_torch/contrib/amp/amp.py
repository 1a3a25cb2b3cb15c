"""Automatic mixed precision (reference: python/mxnet/contrib/amp/amp.py).

The port of ``mxnet_tpu/contrib/amp/amp.py``. The target dtype defaults
to **bfloat16**, the tensor cores' input type on the H100; its exponent
range is float32's, so the default flow trains without loss scaling,
and the dynamic :class:`LossScaler` is there for float16 and for users
who ask for it. :func:`init` installs the op-list policy in the op
registry (``ndarray/registry.py``): every op call after it casts its
floating array arguments by the lists, on torch's autograd graph, so
gradients land in each parameter's own dtype.
"""
from __future__ import annotations

from contextlib import contextmanager

from . import lists
from .loss_scaler import LossScaler, _mul
from ...ndarray import registry as _registry

__all__ = ["init", "disable", "init_trainer", "scale_loss", "convert_model",
           "convert_hybrid_block", "convert_symbol"]

_state = {"initialized": False, "target_dtype": None}
_NODE_SERIAL = [0]  # process-wide uniquifier for inserted graph nodes


def init(target_dtype="bfloat16"):
    """Turn on AMP for every op executed from now on."""
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError(f"amp.init: target_dtype must be 'bfloat16' or "
                         f"'float16', got {target_dtype!r}")
    _registry.set_amp(target_dtype,
                      target_ops=lists.TARGET_DTYPE_OPS,
                      fp32_ops=lists.FP32_OPS,
                      widest_ops=lists.WIDEST_TYPE_CASTS,
                      conditional_ops=lists.CONDITIONAL_FP32_OPS)
    _state["initialized"] = True
    _state["target_dtype"] = target_dtype


def disable():
    """Turn AMP back off (the JAX package's testing convenience; the
    reference has no inverse)."""
    _registry.set_amp(None)
    _state["initialized"] = False
    _state["target_dtype"] = None


def init_trainer(trainer):
    """Attach a dynamic loss scaler to a Gluon Trainer (reference:
    amp.py:288 init_trainer)."""
    if not _state["initialized"]:
        raise RuntimeError("call amp.init() before amp.init_trainer()")
    trainer._amp_loss_scaler = LossScaler()
    return trainer


@contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``
    (reference: amp.py scale_loss). Multiplies the loss by the scale that
    ``trainer.step`` divides the gradients by: on the fused step that is
    the device scale itself, read by no host sync."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    scale = trainer._loss_scale_operand()
    if isinstance(loss, (list, tuple)):
        yield [_mul(l, scale) for l in loss]
    else:
        yield _mul(loss, scale)


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, widest_dtype_ops=None,
                   excluded_sym_names=()):
    """Graph-conversion pass: rebuild the Symbol DAG with ``amp_cast`` /
    ``amp_multicast`` nodes at op boundaries per the op lists.

    Reference: amp.py convert_symbol → src/nnvm/low_precision_pass.cc
    ReducePrecision. Target-list ops get their inputs amp_cast to the
    target dtype, fp32-list ops (and conditional ops whose attribute
    matches) get amp_cast to float32 (amp_cast only touches floating
    tensors, so casting blindly is safe), widest-list ops route all
    inputs through one amp_multicast node. The pass is structural — no
    parameter values are touched — so the result evaluates, writes to
    JSON and infers shapes like any graph.
    """
    from ...symbol import Symbol

    tgt = set(lists.TARGET_DTYPE_OPS if target_dtype_ops is None
              else target_dtype_ops)
    f32 = set(lists.FP32_OPS if fp32_ops is None else fp32_ops)
    widest = set(lists.WIDEST_TYPE_CASTS if widest_dtype_ops is None
                 else widest_dtype_ops)
    excluded = set(excluded_sym_names)
    memo = {}
    # tojson collapses nodes by name: every inserted node needs a name
    # unique across all conversions
    serial = _NODE_SERIAL

    def cast_in(s, dtype, tag):
        serial[0] += 1
        nm = (f"{s._name or s._op or 'sym'}_amp_cast_{dtype}_"
              f"{tag}_{serial[0]}")
        return Symbol(op="amp_cast", name=nm, inputs=[s],
                      kwargs={"dtype": dtype})

    def conv(s):
        # output views of one multi-output node share the base node's
        # _inputs/_kwargs objects: memoize by that identity so every view
        # maps onto views of one converted node
        if s._group is not None or s._op is None:
            key = id(s)
        else:
            key = (s._op, id(s._inputs), id(s._kwargs), s._name)
        base = memo.get(key)
        if base is None:
            if s._group is not None:
                base = Symbol(group=[conv(g) for g in s._group])
                memo[key] = base
                return base
            ins = [conv(i) for i in s._inputs]
            op, name = s._op, s._name
            cond_f32 = any(
                op == c_op and str(s._kwargs.get(c_attr)) in c_vals
                for c_op, c_attr, c_vals in lists.CONDITIONAL_FP32_OPS)
            if op is not None and name not in excluded:
                if cond_f32:
                    ins = [cast_in(x, "float32", i)
                           for i, x in enumerate(ins)]
                elif op in tgt:
                    ins = [cast_in(x, target_dtype, i)
                           for i, x in enumerate(ins)]
                elif op in f32:
                    ins = [cast_in(x, "float32", i)
                           for i, x in enumerate(ins)]
                elif op in widest and len(ins) > 1:
                    serial[0] += 1
                    mc = Symbol(op="amp_multicast",
                                name=f"{name or op}_amp_multicast_"
                                     f"{serial[0]}",
                                inputs=ins,
                                kwargs={"num_outputs": len(ins)},
                                num_outputs=len(ins))
                    ins = [mc[i] for i in range(len(ins))]
            base = Symbol(op=op, name=name, inputs=ins,
                          kwargs=dict(s._kwargs),
                          num_outputs=s._num_outputs)
            base._attrs = dict(s._attrs)
            memo[key] = base
        if s._op is not None and s._num_outputs > 1:
            return base[s._output_index]
        return base

    return conv(sym)


def convert_model(sym_or_net, arg_params=None, aux_params=None,
                  target_dtype="bfloat16", **kwargs):
    """Reference amp.py convert_model: a symbol ``(sym, arg_params,
    aux_params)`` goes through :func:`convert_symbol` and comes back as
    the converted triple; a Gluon block is cast with its norm layers
    kept in float32, including the positional form
    ``convert_model(net, dtype)``."""
    from ...symbol import Symbol

    if isinstance(sym_or_net, Symbol):
        out = convert_symbol(sym_or_net, target_dtype=target_dtype,
                             **kwargs)
        return out, dict(arg_params or {}), dict(aux_params or {})
    if isinstance(arg_params, str):  # convert_model(net, "float16")
        target_dtype = arg_params
    elif arg_params is not None or aux_params is not None:
        raise TypeError(
            "arg_params/aux_params only apply to symbolic conversion; "
            "for Gluon blocks use convert_model(net, target_dtype=...)")
    sym_or_net.cast(target_dtype)
    return sym_or_net


def convert_hybrid_block(net, target_dtype="bfloat16"):
    """Cast a Gluon block's parameters to the target dtype, keeping norm
    layers in float32 (reference: amp.py convert_hybrid_block;
    ``BatchNorm.cast`` pins its own)."""
    net.cast(target_dtype)
    return net
