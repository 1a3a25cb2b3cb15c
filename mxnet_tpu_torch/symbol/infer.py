"""Partial shape and dtype inference over a Symbol DAG.

The PyTorch counterpart of ``mxnet_tpu/symbol/infer.py`` (reference:
src/executor/infer_graph_attr_pass.cc, forward FInferShape with partial
information). Per node, unknown *parameter* input shapes come from the
layer rules (each NN op's FInferShape in the reference); then the node's
output shape comes from running the op's own body on ``meta`` tensors,
which carry shapes and dtypes and no data — the port's counterpart of
the JAX package's ``jax.eval_shape``. The op body is its own shape
function, so there is no second rule table to keep in step.
"""
from __future__ import annotations

import inspect

import numpy as onp
import torch

from ..base import MXNetError
from ..ndarray import registry as _registry
from ..ndarray.ndarray import _numpy_dtype, torch_dtype

_META = torch.device("meta")
# the widest-type rule's order of float dtypes (amp_multicast)
_FLOAT_ORDER = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_CHANNEL_LAST = ("NWC", "NHWC", "NDHWC")
_CONST_OPS = ("_sym_zeros", "_sym_ones", "_sym_constant")


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def _param_shape_rules(op, kw, in_shapes, arg_names):
    """Given the data shape (input 0), ``{input index: shape}`` for the
    unknown parameter inputs of ``op``."""
    data = in_shapes.get(0)
    if data is None:
        return {}
    out = {}

    def named(name):
        return arg_names.index(name) if name in arg_names else None

    if op.startswith("_contrib_quantized_"):
        # offline-quantized range variables (``*_min``/``*_max``) are
        # (1,)-shaped, as quantize_model's ``nd.array([±amax])``
        for r in ("min_data", "max_data", "min_weight", "max_weight",
                  "min_bias", "max_bias"):
            out[named(r)] = (1,)
    if op in ("fully_connected", "_contrib_quantized_fully_connected"):
        in_units = _prod(data[1:]) if kw.get("flatten", True) else data[-1]
        out[named("weight")] = (kw.get("num_hidden"), in_units)
        out[named("bias")] = (kw.get("num_hidden"),)
    elif op in ("convolution", "_contrib_quantized_conv"):
        kernel = kw.get("kernel")
        nf, g = kw.get("num_filter"), kw.get("num_group", 1)
        out[named("bias")] = (nf,)
        if kernel is not None:
            kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
            # the channel-last weight is (O, *k, I/g): the JAX rule reads
            # the channel from data[1], right only for channel-first data
            if kw.get("layout") in _CHANNEL_LAST:
                out[named("weight")] = (nf,) + kernel + (data[-1] // g,)
            else:
                out[named("weight")] = (nf, data[1] // g) + kernel
    elif op == "deconvolution":
        kernel = kw.get("kernel")
        nf, g = kw.get("num_filter"), kw.get("num_group", 1)
        out[named("bias")] = (nf,)
        if kernel is not None:
            kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
            out[named("weight")] = (data[1], nf // g) + kernel
    elif op == "instance_norm":
        out[named("gamma")] = (data[1],)
        out[named("beta")] = (data[1],)
    elif op == "group_norm":
        # per group (group_norm-inl.h:163); the JAX rule's (C,) would not
        # fit the op
        g = (kw.get("num_groups", 1),)
        out[named("gamma")] = g
        out[named("beta")] = g
    elif op in ("batch_norm", "_contrib_quantized_batch_norm"):
        # the quantized one is formed for axis 1 only (the pass gates it)
        c = (data[kw.get("axis", 1)],)
        for pname in ("gamma", "beta", "moving_mean", "moving_var"):
            out[named(pname)] = c
    elif op == "layer_norm":
        c = (data[kw.get("axis", -1)],)
        out[named("gamma")] = c
        out[named("beta")] = c
    elif op == "embedding":
        out[named("weight")] = (kw.get("input_dim"), kw.get("output_dim"))
    elif op == "leaky_relu" and kw.get("act_type") == "prelu":
        out[named("gamma")] = (data[1] if len(data) > 1 else 1,)
    elif op == "rnn":
        from ..ndarray.ops_nn import rnn_param_size

        H, L = kw.get("state_size"), kw.get("num_layers", 1)
        bi = kw.get("bidirectional", False)
        out[named("parameters")] = (rnn_param_size(
            L, data[-1], H, bi, kw.get("mode", "lstm")),)
        st = (L * (2 if bi else 1), data[1], H)
        out[named("state")] = st
        out[named("state_cell")] = st
    elif op == "softmax_output":
        # the label is the data without its class axis (reference
        # softmax_output.cc FInferShape); axis 1 with multi_output
        out[named("label")] = (data[0],) + tuple(data[2:]) \
            if kw.get("multi_output") else tuple(data[:-1])
    elif op in ("linear_regression_output", "mae_regression_output",
                "logistic_regression_output"):
        out[named("label")] = tuple(data)
    elif op == "svm_output":
        # class indices, as softmax_output's (reference svm_output.cc)
        out[named("label")] = tuple(data[:-1])
    return {k: v for k, v in out.items() if k is not None}


def _array_arg_names(opdef):
    sig = inspect.signature(opdef.fn)
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)]


def infer_shapes(symbol, known, allow_unknown=False,
                 return_node_shapes=False, dtypes=None):
    """Walk the DAG; return ``({var name: shape}, [output shapes])``.

    ``known`` maps variable names to shapes, ``dtypes`` (optional) to
    dtypes (float32 otherwise). Unknown parameter shapes come from the
    layer rules; a shape still unknown raises :class:`MXNetError`
    unless ``allow_unknown``. With ``return_node_shapes`` two more
    tables ride along, ``id(node) -> shape`` (a list for a multi-output
    node) and ``id(node) -> torch dtype`` — the fusion cost model prices
    clusters off them without a second walk."""
    var_shapes = dict(known)
    var_dtypes = {k: torch_dtype(v) for k, v in (dtypes or {}).items()}
    node_out, node_dt = {}, {}

    for node in symbol._walk():
        if node._group is not None:
            continue
        nid = id(node)
        if node._op is None:
            if node._name in var_shapes:
                node_out[nid] = tuple(var_shapes[node._name])
                node_dt[nid] = var_dtypes.get(node._name, torch.float32)
            continue
        if node._op in _CONST_OPS:
            shape = node._kwargs["shape"]
            node_out[nid] = (shape,) if isinstance(shape, int) \
                else tuple(shape)
            node_dt[nid] = torch_dtype(node._kwargs.get("dtype", "float32"))
            continue
        opdef = _registry.get_op(node._op)
        if opdef is None:
            raise MXNetError(f"op '{node._op}' is not registered")
        in_shapes, in_dts = {}, {}
        for i, inp in enumerate(node._inputs):
            s = node_out.get(id(inp))
            d = node_dt.get(id(inp))
            if isinstance(s, list):
                s, d = s[inp._output_index], d[inp._output_index]
            if s is not None:
                in_shapes[i], in_dts[i] = s, d
        if len(in_shapes) < len(node._inputs):
            rules = _param_shape_rules(node._op, node._kwargs, in_shapes,
                                       _array_arg_names(opdef))
            for i, inp in enumerate(node._inputs):
                if i not in in_shapes and inp._op is None and i in rules:
                    shape = tuple(rules[i])
                    var_shapes[inp._name] = shape
                    node_out[id(inp)] = in_shapes[i] = shape
                    node_dt[id(inp)] = in_dts[i] = var_dtypes.get(
                        inp._name, torch.float32)
        if len(in_shapes) < len(node._inputs):
            if allow_unknown:
                continue
            missing = [node._inputs[i]._name for i in
                       range(len(node._inputs)) if i not in in_shapes]
            raise MXNetError(f"cannot infer shape for inputs {missing} of "
                             f"op '{node._op}' ({node._name})")
        xs = [torch.empty(in_shapes[i], dtype=in_dts[i], device=_META)
              for i in range(len(node._inputs))]
        try:
            with torch.no_grad():
                o = opdef.fn(*xs, **dict(node._kwargs))
        except Exception as e:
            raise MXNetError(
                f"shape inference failed at op '{node._op}' ({node._name}) "
                f"with input shapes {[tuple(x.shape) for x in xs]}: "
                f"{e}") from e
        if isinstance(o, (list, tuple)):
            node_out[nid] = [tuple(x.shape) for x in o]
            node_dt[nid] = [x.dtype for x in o]
        else:
            node_out[nid] = tuple(o.shape)
            node_dt[nid] = o.dtype

    out_shapes = []
    for h in (symbol._group if symbol._group else [symbol]):
        s = node_out.get(id(h))
        if isinstance(s, list):
            s = s[h._output_index]
        out_shapes.append(s)
    if return_node_shapes:
        return var_shapes, out_shapes, node_out, node_dt
    return var_shapes, out_shapes


def _promote(dts):
    """The promoted numpy dtype of ``dts`` under torch's rules (the
    JAX package uses ``jnp.result_type``)."""
    out = None
    for d in dts:
        t = torch_dtype(onp.dtype(d))
        out = t if out is None else torch.promote_types(out, t)
    return onp.dtype(str(out).replace("torch.", ""))


# the dtype rules of the quantization ops (``mxnet_tpu/symbol/infer.py:
# 246-300``): fixed output dtypes, int8 offline weights (without the entry
# the sibling rule would promote them to the ranges' float32), and the
# (payload, float32 min, float32 max) triples
_FIXED_OUT_DTYPE = {"dequantize": onp.float32}
_PARAM_DTYPE_DEFAULTS = {
    "_contrib_quantized_conv": {1: onp.int8},
    "_contrib_quantized_fully_connected": {1: onp.int8},
}
#: int32 accumulators (a following requantize narrows them)
_QUANT_ACC_OPS = ("_contrib_quantized_conv",
                  "_contrib_quantized_fully_connected",
                  "_contrib_quantized_batch_dot")
#: int8 payloads on a fresh lattice
_QUANT_S8_OPS = ("_contrib_quantized_elemwise_add",
                 "_contrib_quantized_concat",
                 "_contrib_quantized_batch_norm")
#: the input lattice (int8 or uint8) passed through
_QUANT_PASSTHROUGH_OPS = ("_contrib_quantized_act",
                          "_contrib_quantized_flatten",
                          "_contrib_quantized_pooling")


def _quant_out_dtype(op, kw, in_dtypes):
    """The output dtype(s) of a quantization op, or None for other ops."""
    f32 = onp.dtype(onp.float32)
    if op in _FIXED_OUT_DTYPE:
        return onp.dtype(_FIXED_OUT_DTYPE[op])
    if op in ("quantize", "quantize_v2"):
        q = kw.get("out_type", "uint8" if op == "quantize" else "int8")
        return [onp.dtype(q), f32, f32]
    if op == "requantize":
        return [onp.dtype(kw.get("out_type", "int8")), f32, f32]
    if op in _QUANT_ACC_OPS:
        return [onp.dtype(onp.int32), f32, f32]
    if op in _QUANT_S8_OPS:
        return [onp.dtype(onp.int8), f32, f32]
    if op in _QUANT_PASSTHROUGH_OPS:
        return [onp.dtype(in_dtypes.get(0, onp.int8)), f32, f32]
    return None


def infer_types(symbol, known):
    """Forward dtype propagation: ``({var name: dtype}, [output
    dtypes])``. Unknown parameter variables take the promoted dtype of
    their node's known inputs; an embedding's weight is float32 whatever
    its index dtype."""
    f32 = onp.dtype(onp.float32)
    var_types = {k: onp.dtype(v) for k, v in known.items()}
    node_out = {}
    for node in symbol._walk():
        if node._group is not None:
            continue
        if node._op is None:
            if node._name in var_types:
                node_out[id(node)] = var_types[node._name]
            continue
        in_dtypes = {}
        for i, inp in enumerate(node._inputs):
            d = node_out.get(id(inp))
            if isinstance(d, list):
                d = d[min(inp._output_index, len(d) - 1)]
            if d is not None:
                in_dtypes[i] = d
        if node._op == "embedding" and len(node._inputs) > 1 \
                and 1 not in in_dtypes and node._inputs[1]._op is None:
            var_types.setdefault(node._inputs[1]._name, f32)
            node_out[id(node._inputs[1])] = in_dtypes[1] = \
                var_types[node._inputs[1]._name]
        for i, dt in _PARAM_DTYPE_DEFAULTS.get(node._op, {}).items():
            if i < len(node._inputs) and i not in in_dtypes and \
                    node._inputs[i]._op is None:
                var_types.setdefault(node._inputs[i]._name, onp.dtype(dt))
                node_out[id(node._inputs[i])] = in_dtypes[i] = \
                    var_types[node._inputs[i]._name]
        if in_dtypes and len(in_dtypes) < len(node._inputs):
            sib = _promote(in_dtypes.values())
            for i, inp in enumerate(node._inputs):
                if i not in in_dtypes and inp._op is None:
                    var_types.setdefault(inp._name, sib)
                    node_out[id(inp)] = in_dtypes[i] = var_types[inp._name]
        quant = _quant_out_dtype(node._op, node._kwargs, in_dtypes)
        if quant is not None:
            node_out[id(node)] = quant
            continue
        if node._op in _CONST_OPS:
            out_d = onp.dtype(node._kwargs.get("dtype", "float32"))
        elif node._op == "amp_cast":
            out_d = in_dtypes.get(0, f32)
            if onp.dtype(out_d).kind == "f" or str(out_d) == "bfloat16":
                out_d = _numpy_dtype(torch_dtype(
                    node._kwargs.get("dtype", "float32")))
        elif node._op == "amp_multicast":
            ds = [in_dtypes.get(i, f32) for i in range(len(node._inputs))]
            fl = [torch_dtype(d) for d in ds
                  if str(d) == "bfloat16" or onp.dtype(d).kind == "f"]
            widest = _numpy_dtype(max(fl, key=_FLOAT_ORDER.index)) \
                if fl else None
            node_out[id(node)] = [
                widest if widest is not None and (
                    str(d) == "bfloat16" or onp.dtype(d).kind == "f")
                else d for d in ds]
            continue
        elif node._op == "embedding":
            out_d = in_dtypes.get(1, f32)
        elif in_dtypes:
            out_d = _promote(in_dtypes.values())
        else:
            out_d = f32
        node_out[id(node)] = out_d
    out_types = []
    for h in (symbol._group if symbol._group else [symbol]):
        d = node_out.get(id(h), f32)
        if isinstance(d, list):  # one output of a multi-output node
            out_types.append(d[min(h._output_index, len(d) - 1)])
            continue
        out_types.extend([d] * (getattr(h, "_num_outputs", 1) or 1))
    return var_types, out_types
