"""An ONNX file to a Symbol and its parameters (``import_model``,
``get_model_metadata``, ``import_to_gluon``).

The PyTorch counterpart of ``mxnet_tpu/contrib/onnx/onnx2mx.py``
(reference: python/mxnet/contrib/onnx/onnx2mx/_op_translations.py and
import_onnx.py ``GraphProto``): builds a Symbol DAG and the arg and aux
parameter dicts from a ``ModelProto`` read by the wire codec of
:mod:`._wire`. Aux states are the BatchNormalization mean and variance
inputs, as in the reference importer. ``raw_data`` initializers are read
in place by ``numpy.frombuffer``. The parameters land on ``ctx``
(default: the current context, the card); an op with no translation
raises.
"""
from __future__ import annotations

import warnings

import numpy as onp

from . import _wire as O
from ...base import MXNetError

_ONNX_TO_DTYPE = {O.TensorProto.FLOAT: "float32",
                  O.TensorProto.DOUBLE: "float64",
                  O.TensorProto.FLOAT16: "float16",
                  O.TensorProto.BFLOAT16: "bfloat16",
                  O.TensorProto.UINT8: "uint8",
                  O.TensorProto.INT8: "int8",
                  O.TensorProto.INT32: "int32",
                  O.TensorProto.INT64: "int64",
                  O.TensorProto.BOOL: "bool"}


def _tensor_to_numpy(t):
    dtype = _ONNX_TO_DTYPE.get(t.data_type)
    if dtype is None:
        raise MXNetError(f"unsupported ONNX tensor dtype {t.data_type}")
    shape = tuple(t.dims)
    if t.raw_data:
        arr = onp.frombuffer(t.raw_data, dtype=onp.dtype(dtype)
                             if dtype != "bfloat16" else onp.uint16)
        if dtype == "bfloat16":
            arr = (arr.astype(onp.uint32) << 16).view(onp.float32)
    elif t.float_data:
        arr = onp.asarray(list(t.float_data), dtype=dtype)
    elif t.int64_data:
        arr = onp.asarray(list(t.int64_data), dtype=dtype)
    elif t.int32_data:
        arr = onp.asarray(list(t.int32_data), dtype=dtype)
    elif t.double_data:
        arr = onp.asarray(list(t.double_data), dtype=dtype)
    else:
        arr = onp.zeros(shape, dtype=dtype)
    return arr.reshape(shape)


def _attrs(node):
    out = {}
    for a in node.attribute:
        if a.type == O.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == O.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == O.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == O.AttributeProto.INTS:
            out[a.name] = tuple(int(x) for x in a.ints)
        elif a.type == O.AttributeProto.FLOATS:
            out[a.name] = tuple(float(x) for x in a.floats)
        elif a.type == O.AttributeProto.TENSOR:
            out[a.name] = _tensor_to_numpy(a.t)
        else:
            out[a.name] = None
    return out


def _split_pads(pads):
    """ONNX pads [b0,b1,...,e0,e1,...] -> symmetric mxnet pad or raise."""
    if not pads:
        return None
    n = len(pads) // 2
    before, after = pads[:n], pads[n:]
    if tuple(before) != tuple(after):
        raise MXNetError(f"asymmetric pads {pads} not supported")
    return tuple(before)


class _Importer:
    def __init__(self, model, ctx=None):
        from ... import symbol as sym

        self.sym = sym
        self.model = model
        self.ctx = ctx
        self.tensors = {}  # onnx tensor name -> Symbol
        self.params = {}  # name -> numpy (initializers)
        self.aux_names = set()

    def const_value(self, name):
        """Numpy value of an initializer-backed tensor (for Reshape
        shapes, Clip bounds, ...)."""
        if name in self.params:
            return self.params[name]
        raise MXNetError(f"expected constant input '{name}'")

    def run(self):
        g = self.model.graph
        for t in g.initializer:
            self.params[t.name] = _tensor_to_numpy(t)
        for vi in g.input:
            if vi.name not in self.params:
                self.tensors[vi.name] = self.sym.var(vi.name)
        for node in g.node:
            fn = ONNX2MX_OPS.get(node.op_type)
            if fn is None:
                raise MXNetError(
                    f"ONNX op '{node.op_type}' has no import translation")
            fn(self, node, _attrs(node))
        outs = [self.tensors[o.name] for o in g.output]
        out = outs[0] if len(outs) == 1 else self.sym.Group(outs)
        from ... import ndarray as nd

        args, aux = {}, {}
        # params consumed as graph tensors become Variables lazily; only
        # those referenced by the built graph are returned
        used = {s._name for s in out._walk() if s._op is None}
        with warnings.catch_warnings():
            # the initializers are read-only views of the file's bytes,
            # which nd.array copies
            warnings.filterwarnings(
                "ignore", message="The given NumPy array is not writable")
            for name, arr in self.params.items():
                if name not in used:
                    continue
                dst = aux if name in self.aux_names else args
                dst[name] = nd.array(arr, ctx=self.ctx)
        return out, args, aux

    def inp(self, name):
        """Symbol for a tensor name; initializers materialize as vars."""
        if name in self.tensors:
            return self.tensors[name]
        if name in self.params:
            v = self.sym.var(name)
            self.tensors[name] = v
            return v
        raise MXNetError(f"undefined tensor '{name}'")


ONNX2MX_OPS = {}


def register_import(*ops):
    def deco(fn):
        for n in ops:
            ONNX2MX_OPS[n] = fn
        return fn

    return deco


def _set(ctx, node, symbol):
    ctx.tensors[node.output[0]] = symbol


@register_import("Conv")
def _conv(ctx, node, attrs):
    ins = [ctx.inp(n) for n in node.input]
    w = ctx.const_value(node.input[1])
    ctx.tensors[node.output[0]] = ctx.sym.convolution(
        *ins,
        kernel=tuple(attrs.get("kernel_shape") or w.shape[2:]),
        stride=tuple(attrs.get("strides") or ()) or None,
        dilate=tuple(attrs.get("dilations") or ()) or None,
        pad=_split_pads(attrs.get("pads")),
        num_filter=int(w.shape[0]),
        num_group=int(attrs.get("group", 1)),
        no_bias=len(node.input) < 3,
        name=node.name or node.output[0])


@register_import("ConvTranspose")
def _deconv(ctx, node, attrs):
    ins = [ctx.inp(n) for n in node.input]
    w = ctx.const_value(node.input[1])
    ctx.tensors[node.output[0]] = ctx.sym.deconvolution(
        *ins,
        kernel=tuple(attrs.get("kernel_shape") or w.shape[2:]),
        stride=tuple(attrs.get("strides") or ()) or None,
        dilate=tuple(attrs.get("dilations") or ()) or None,
        pad=_split_pads(attrs.get("pads")),
        num_filter=int(w.shape[1]) * int(attrs.get("group", 1)),
        num_group=int(attrs.get("group", 1)),
        no_bias=len(node.input) < 3,
        name=node.name or node.output[0])


@register_import("BatchNormalization")
def _bn(ctx, node, attrs):
    ins = [ctx.inp(n) for n in node.input[:5]]
    ctx.aux_names.update(node.input[3:5])
    # ONNX BatchNormalization (single output) is inference mode: always
    # normalize with the running statistics, never batch stats
    _set(ctx, node, ctx.sym.batch_norm(
        *ins, eps=float(attrs.get("epsilon", 1e-5)),
        momentum=float(attrs.get("momentum", 0.9)),
        fix_gamma=False, use_global_stats=True, use_batch_stats=False,
        name=node.name or node.output[0]))


@register_import("Gemm")
def _gemm(ctx, node, attrs):
    if attrs.get("alpha", 1.0) != 1.0 or attrs.get("beta", 1.0) != 1.0 \
            or attrs.get("transA", 0):
        raise MXNetError("Gemm with alpha/beta/transA != defaults "
                         "not supported")
    w = ctx.const_value(node.input[1])
    if not attrs.get("transB", 0):
        # mxnet FC weight is (num_hidden, in); rewrite the initializer
        w = onp.ascontiguousarray(w.T)
        ctx.params[node.input[1]] = w
    ins = [ctx.inp(n) for n in node.input]
    _set(ctx, node, ctx.sym.fully_connected(
        *ins, num_hidden=int(w.shape[0]), no_bias=len(node.input) < 3,
        flatten=False, name=node.name or node.output[0]))


@register_import("MatMul")
def _matmul(ctx, node, attrs):
    a, b = (ctx.inp(n) for n in node.input[:2])
    _set(ctx, node, ctx.sym.dot(a, b, name=node.name or node.output[0]))


@register_import("MaxPool", "AveragePool")
def _pool(ctx, node, attrs):
    x = ctx.inp(node.input[0])
    kwargs = dict(
        kernel=tuple(attrs.get("kernel_shape") or ()),
        stride=tuple(attrs.get("strides") or ()) or None,
        pad=_split_pads(attrs.get("pads")),
        pool_type="max" if node.op_type == "MaxPool" else "avg",
        pooling_convention="full" if attrs.get("ceil_mode") else "valid")
    if node.op_type == "AveragePool":
        kwargs["count_include_pad"] = bool(
            attrs.get("count_include_pad", 1))
    _set(ctx, node, ctx.sym.pooling(
        x, name=node.name or node.output[0], **kwargs))


@register_import("GlobalMaxPool", "GlobalAveragePool")
def _gpool(ctx, node, attrs):
    x = ctx.inp(node.input[0])
    _set(ctx, node, ctx.sym.pooling(
        x, global_pool=True,
        pool_type="max" if "Max" in node.op_type else "avg",
        name=node.name or node.output[0]))


for _onnx, _act in [("Relu", "relu"), ("Sigmoid", "sigmoid"),
                    ("Tanh", "tanh"), ("Softplus", "softrelu"),
                    ("Softsign", "softsign")]:
    def _mk_act(act):
        def tr(ctx, node, attrs):
            _set(ctx, node, ctx.sym.activation(
                ctx.inp(node.input[0]), act_type=act,
                name=node.name or node.output[0]))
        return tr
    register_import(_onnx)(_mk_act(_act))


@register_import("LeakyRelu")
def _leaky(ctx, node, attrs):
    _set(ctx, node, ctx.sym.leaky_relu(
        ctx.inp(node.input[0]), act_type="leaky",
        slope=float(attrs.get("alpha", 0.01)),
        name=node.name or node.output[0]))


@register_import("Elu")
def _elu(ctx, node, attrs):
    _set(ctx, node, ctx.sym.leaky_relu(
        ctx.inp(node.input[0]), act_type="elu",
        slope=float(attrs.get("alpha", 1.0)),
        name=node.name or node.output[0]))


@register_import("Selu")
def _selu(ctx, node, attrs):
    _set(ctx, node, ctx.sym.leaky_relu(
        ctx.inp(node.input[0]), act_type="selu",
        name=node.name or node.output[0]))


@register_import("PRelu")
def _prelu(ctx, node, attrs):
    _set(ctx, node, ctx.sym.leaky_relu(
        ctx.inp(node.input[0]), ctx.inp(node.input[1]), act_type="prelu",
        name=node.name or node.output[0]))


@register_import("Flatten")
def _flatten(ctx, node, attrs):
    if int(attrs.get("axis", 1)) != 1:
        raise MXNetError("Flatten axis != 1 not supported")
    _set(ctx, node, ctx.sym.flatten(ctx.inp(node.input[0]),
                                    name=node.name or node.output[0]))


@register_import("Concat")
def _concat(ctx, node, attrs):
    ins = [ctx.inp(n) for n in node.input]
    _set(ctx, node, ctx.sym.concat(*ins, dim=int(attrs.get("axis", 1)),
                                   name=node.name or node.output[0]))


@register_import("Dropout")
def _dropout(ctx, node, attrs):
    p = attrs.get("ratio", 0.5)
    if len(node.input) > 1:
        p = float(onp.asarray(ctx.const_value(node.input[1])).reshape(()))
    _set(ctx, node, ctx.sym.dropout(ctx.inp(node.input[0]), p=p,
                                    name=node.name or node.output[0]))


@register_import("Softmax")
def _softmax(ctx, node, attrs):
    _set(ctx, node, ctx.sym.softmax(
        ctx.inp(node.input[0]), axis=int(attrs.get("axis", -1)),
        name=node.name or node.output[0]))


@register_import("LogSoftmax")
def _log_softmax(ctx, node, attrs):
    _set(ctx, node, ctx.sym.log_softmax(
        ctx.inp(node.input[0]), axis=int(attrs.get("axis", -1)),
        name=node.name or node.output[0]))


@register_import("Clip")
def _clip(ctx, node, attrs):
    lo, hi = attrs.get("min"), attrs.get("max")
    if len(node.input) > 1 and node.input[1]:
        lo = float(onp.asarray(ctx.const_value(node.input[1])).reshape(()))
    if len(node.input) > 2 and node.input[2]:
        hi = float(onp.asarray(ctx.const_value(node.input[2])).reshape(()))
    _set(ctx, node, ctx.sym.clip(
        ctx.inp(node.input[0]),
        a_min=lo if lo is not None else -3.4e38,
        a_max=hi if hi is not None else 3.4e38,
        name=node.name or node.output[0]))


@register_import("Reshape")
def _reshape(ctx, node, attrs):
    shape = attrs.get("shape")
    if shape is None:
        shape = tuple(int(x) for x in ctx.const_value(node.input[1]))
    _set(ctx, node, ctx.sym.reshape(ctx.inp(node.input[0]),
                                    shape=tuple(shape),
                                    name=node.name or node.output[0]))


@register_import("Transpose")
def _transpose(ctx, node, attrs):
    perm = attrs.get("perm")
    _set(ctx, node, ctx.sym.transpose(
        ctx.inp(node.input[0]),
        axes=tuple(perm) if perm else None,
        name=node.name or node.output[0]))


@register_import("Unsqueeze")
def _unsqueeze(ctx, node, attrs):
    axes = attrs.get("axes")
    if axes is None:
        axes = tuple(int(x) for x in ctx.const_value(node.input[1]))
    out = ctx.inp(node.input[0])
    for ax in sorted(axes):
        out = ctx.sym.expand_dims(out, axis=int(ax))
    ctx.tensors[node.output[0]] = out


@register_import("Squeeze")
def _squeeze(ctx, node, attrs):
    axes = attrs.get("axes")
    if axes is None and len(node.input) > 1:
        axes = tuple(int(x) for x in ctx.const_value(node.input[1]))
    _set(ctx, node, ctx.sym.squeeze(
        ctx.inp(node.input[0]),
        axis=tuple(axes) if axes else None,
        name=node.name or node.output[0]))


@register_import("Identity")
def _identity(ctx, node, attrs):
    ctx.tensors[node.output[0]] = ctx.inp(node.input[0])


_SCALAR_FOLD = {"broadcast_add": "broadcast_add_scalar",
                "broadcast_sub": "broadcast_sub_scalar",
                "broadcast_mul": "broadcast_mul_scalar",
                "broadcast_div": "broadcast_div_scalar",
                "broadcast_power": "broadcast_power_scalar",
                "broadcast_maximum": "maximum_scalar",
                "broadcast_minimum": "minimum_scalar"}


for _onnx, _mx in [("Add", "broadcast_add"), ("Sub", "broadcast_sub"),
                   ("Mul", "broadcast_mul"), ("Div", "broadcast_div"),
                   ("Pow", "broadcast_power"),
                   ("Max", "broadcast_maximum"),
                   ("Min", "broadcast_minimum")]:
    def _mk_bin(mxop):
        def tr(ctx, node, attrs):
            n0, n1 = node.input[:2]

            def scalar_const(n):
                """Fold initializer scalars back into op attrs — keeps
                re-imported graphs free of synthetic one-element params
                (reference onnx2mx does the same for broadcast ops)."""
                if n in ctx.params and n not in ctx.tensors:
                    v = onp.asarray(ctx.params[n])
                    if v.size == 1:
                        return float(v.reshape(()))
                return None

            sc = scalar_const(n1)
            scalar_op = _SCALAR_FOLD[mxop]
            if sc is not None:
                _set(ctx, node, getattr(ctx.sym, scalar_op)(
                    ctx.inp(n0), scalar=sc,
                    name=node.name or node.output[0]))
                return
            sc = scalar_const(n0)
            if sc is not None:
                _set(ctx, node, getattr(ctx.sym, scalar_op)(
                    ctx.inp(n1), scalar=sc, reverse=True,
                    name=node.name or node.output[0]))
                return
            a, b = ctx.inp(n0), ctx.inp(n1)
            _set(ctx, node, getattr(ctx.sym, mxop)(
                a, b, name=node.name or node.output[0]))
        return tr
    register_import(_onnx)(_mk_bin(_mx))


for _onnx, _mx in [("Exp", "exp"), ("Log", "log"), ("Sqrt", "sqrt"),
                   ("Abs", "abs"), ("Neg", "negative"),
                   ("Floor", "floor"), ("Ceil", "ceil"), ("Erf", "erf")]:
    def _mk_un(mxop):
        def tr(ctx, node, attrs):
            _set(ctx, node, getattr(ctx.sym, mxop)(
                ctx.inp(node.input[0]), name=node.name or node.output[0]))
        return tr
    register_import(_onnx)(_mk_un(_mx))


def _mk_reduce(mxop):
    def tr(ctx, node, attrs):
        axes = attrs.get("axes")
        if axes is None and len(node.input) > 1:
            axes = tuple(int(x) for x in ctx.const_value(node.input[1]))
        _set(ctx, node, getattr(ctx.sym, mxop)(
            ctx.inp(node.input[0]),
            axis=tuple(axes) if axes is not None else None,
            keepdims=bool(attrs.get("keepdims", 1)),
            name=node.name or node.output[0]))
    return tr


register_import("ReduceMean")(_mk_reduce("mean"))
register_import("ReduceSum")(_mk_reduce("sum"))
register_import("ReduceMax")(_mk_reduce("max"))
register_import("ReduceMin")(_mk_reduce("min"))
register_import("ReduceProd")(_mk_reduce("prod"))


@register_import("Sum")
def _sum_n(ctx, node, attrs):
    ins = [ctx.inp(n) for n in node.input]
    _set(ctx, node, ctx.sym.add_n(*ins, name=node.name or node.output[0]))


@register_import("LRN")
def _lrn(ctx, node, attrs):
    _set(ctx, node, ctx.sym.lrn(
        ctx.inp(node.input[0]), alpha=float(attrs.get("alpha", 1e-4)),
        beta=float(attrs.get("beta", 0.75)),
        knorm=float(attrs.get("bias", 2.0)),
        nsize=int(attrs.get("size", 5)),
        name=node.name or node.output[0]))


@register_import("Pad")
def _pad(ctx, node, attrs):
    pads = attrs.get("pads")
    if pads is None:
        pads = tuple(int(x) for x in ctx.const_value(node.input[1]))
    n = len(pads) // 2
    width = []
    for i in range(n):
        width += [pads[i], pads[n + i]]
    _set(ctx, node, ctx.sym.pad(
        ctx.inp(node.input[0]), mode=attrs.get("mode", "constant"),
        pad_width=tuple(width), name=node.name or node.output[0]))




# ---- the reference _op_translations.py tail, import direction -------------

for _onnx, _mx in [("Sin", "sin"), ("Cos", "cos"), ("Tan", "tan"),
                   ("Asin", "arcsin"), ("Acos", "arccos"),
                   ("Atan", "arctan"), ("Sinh", "sinh"), ("Cosh", "cosh"),
                   ("Round", "round"), ("Sign", "sign"),
                   ("Reciprocal", "reciprocal")]:
    def _mk_un2(mxop):
        def tr(ctx, node, attrs):
            _set(ctx, node, getattr(ctx.sym, mxop)(
                ctx.inp(node.input[0]), name=node.name or node.output[0]))
        return tr
    if _onnx not in ONNX2MX_OPS:
        register_import(_onnx)(_mk_un2(_mx))


for _onnx, _mx in [("Greater", "broadcast_greater"),
                   ("Less", "broadcast_lesser"),
                   ("Equal", "broadcast_equal"),
                   ("GreaterOrEqual", "broadcast_greater_equal"),
                   ("LessOrEqual", "broadcast_lesser_equal")]:
    def _mk_cmp(mxop):
        def tr(ctx, node, attrs):
            _set(ctx, node, getattr(ctx.sym, mxop)(
                ctx.inp(node.input[0]), ctx.inp(node.input[1]),
                name=node.name or node.output[0]))
        return tr
    register_import(_onnx)(_mk_cmp(_mx))


@register_import("Not")
def _not(ctx, node, attrs):
    x = ctx.inp(node.input[0])
    _set(ctx, node, ctx.sym.broadcast_equal(
        x, ctx.sym.zeros_like(x), name=node.name or node.output[0]))


@register_import("Where")
def _where(ctx, node, attrs):
    _set(ctx, node, ctx.sym.where(
        ctx.inp(node.input[0]), ctx.inp(node.input[1]),
        ctx.inp(node.input[2]), name=node.name or node.output[0]))


@register_import("Cast")
def _cast_imp(ctx, node, attrs):
    dt = _ONNX_TO_DTYPE.get(int(attrs.get("to", O.TensorProto.FLOAT)),
                            "float32")
    _set(ctx, node, ctx.sym.cast(ctx.inp(node.input[0]), dtype=dt,
                                 name=node.name or node.output[0]))


@register_import("Slice")
def _slice_imp(ctx, node, attrs):
    if "starts" in attrs:  # opset<10 attribute form
        starts = tuple(attrs["starts"])
        ends = tuple(attrs["ends"])
        axes = tuple(attrs.get("axes", range(len(starts))))
        steps = (1,) * len(starts)
    else:
        starts = tuple(int(x) for x in ctx.const_value(node.input[1]))
        ends = tuple(int(x) for x in ctx.const_value(node.input[2]))
        axes = tuple(int(x) for x in ctx.const_value(node.input[3])) \
            if len(node.input) > 3 else tuple(range(len(starts)))
        steps = tuple(int(x) for x in ctx.const_value(node.input[4])) \
            if len(node.input) > 4 else (1,) * len(starts)
    out = ctx.inp(node.input[0])
    big = 2 ** 31 - 1
    for ax, s, e, st in zip(axes, starts, ends, steps):
        if st != 1:
            raise MXNetError("Slice import supports step 1 only")
        out = ctx.sym.slice_axis(out, axis=int(ax), begin=int(s),
                                 end=None if e >= big else int(e))
    out._name = node.name or node.output[0]
    _set(ctx, node, out)


@register_import("Split")
def _split_imp(ctx, node, attrs):
    n = len(node.output)
    axis = int(attrs.get("axis", 0))
    sizes = attrs.get("split")
    if sizes is None and len(node.input) > 1 and node.input[1]:
        sizes = tuple(int(x) for x in ctx.const_value(node.input[1]))
    if sizes is not None and len(set(sizes)) > 1:
        # uneven split: slice_axis chain honoring the exact sizes
        start = 0
        for oname, sz in zip(node.output, sizes):
            ctx.tensors[oname] = ctx.sym.slice_axis(
                ctx.inp(node.input[0]), axis=axis, begin=start,
                end=start + int(sz))
            start += int(sz)
        return
    parts = ctx.sym.split(ctx.inp(node.input[0]), num_outputs=n,
                          axis=axis, name=node.name or node.output[0])
    for i, oname in enumerate(node.output):
        ctx.tensors[oname] = parts[i] if n > 1 else parts


@register_import("Gather")
def _gather(ctx, node, attrs):
    _set(ctx, node, ctx.sym.take(
        ctx.inp(node.input[0]), ctx.inp(node.input[1]),
        axis=int(attrs.get("axis", 0)),
        name=node.name or node.output[0]))


@register_import("GatherND")
def _gather_nd(ctx, node, attrs):
    # ONNX puts the index tuple on the LAST indices axis, mx gather_nd
    # on the FIRST — full-reverse transpose maps rank-2 indices exactly
    idx = ctx.sym.transpose(ctx.inp(node.input[1]))
    _set(ctx, node, ctx.sym.gather_nd(
        ctx.inp(node.input[0]), idx,
        name=node.name or node.output[0]))


@register_import("Tile")
def _tile_imp(ctx, node, attrs):
    reps = tuple(int(x) for x in ctx.const_value(node.input[1]))
    _set(ctx, node, ctx.sym.tile(ctx.inp(node.input[0]), reps=reps,
                                 name=node.name or node.output[0]))


@register_import("Expand")
def _expand(ctx, node, attrs):
    shape = tuple(int(x) for x in ctx.const_value(node.input[1]))
    _set(ctx, node, ctx.sym.broadcast_to(
        ctx.inp(node.input[0]), shape=shape,
        name=node.name or node.output[0]))


@register_import("Shape")
def _shape_imp(ctx, node, attrs):
    _set(ctx, node, ctx.sym.shape_array(
        ctx.inp(node.input[0]), name=node.name or node.output[0]))


@register_import("OneHot")
def _one_hot_imp(ctx, node, attrs):
    depth = int(onp.asarray(ctx.const_value(node.input[1])).reshape(()))
    vals = onp.asarray(ctx.const_value(node.input[2])).reshape(-1)
    _set(ctx, node, ctx.sym.one_hot(
        ctx.inp(node.input[0]), depth=depth,
        off_value=float(vals[0]), on_value=float(vals[1]),
        name=node.name or node.output[0]))


@register_import("ArgMax")
def _argmax_imp(ctx, node, attrs):
    _set(ctx, node, ctx.sym.argmax(
        ctx.inp(node.input[0]), axis=int(attrs.get("axis", 0)),
        keepdims=bool(attrs.get("keepdims", 1)),
        name=node.name or node.output[0]))


@register_import("ArgMin")
def _argmin_imp(ctx, node, attrs):
    _set(ctx, node, ctx.sym.argmin(
        ctx.inp(node.input[0]), axis=int(attrs.get("axis", 0)),
        keepdims=bool(attrs.get("keepdims", 1)),
        name=node.name or node.output[0]))


@register_import("TopK")
def _topk_imp(ctx, node, attrs):
    k = int(onp.asarray(ctx.const_value(node.input[1])).reshape(-1)[0])
    res = ctx.sym.topk(ctx.inp(node.input[0]), k=k,
                       axis=int(attrs.get("axis", -1)),
                       ret_typ="both",
                       is_ascend=not bool(attrs.get("largest", 1)),
                       name=node.name or node.output[0])
    ctx.tensors[node.output[0]] = res[0]
    if len(node.output) > 1:
        ctx.tensors[node.output[1]] = res[1]


@register_import("LayerNormalization")
def _layer_norm_imp(ctx, node, attrs):
    _set(ctx, node, ctx.sym.layer_norm(
        ctx.inp(node.input[0]), ctx.inp(node.input[1]),
        ctx.inp(node.input[2]), axis=int(attrs.get("axis", -1)),
        eps=float(attrs.get("epsilon", 1e-5)),
        name=node.name or node.output[0]))


@register_import("InstanceNormalization")
def _instance_norm_imp(ctx, node, attrs):
    _set(ctx, node, ctx.sym.instance_norm(
        ctx.inp(node.input[0]), ctx.inp(node.input[1]),
        ctx.inp(node.input[2]), eps=float(attrs.get("epsilon", 1e-3)),
        name=node.name or node.output[0]))


@register_import("ReduceL1")
def _reduce_l1(ctx, node, attrs):
    axes = attrs.get("axes")
    _set(ctx, node, ctx.sym.norm(
        ctx.inp(node.input[0]), ord=1,
        axis=tuple(axes) if axes else None,
        keepdims=bool(attrs.get("keepdims", 1)),
        name=node.name or node.output[0]))


@register_import("ReduceL2")
def _reduce_l2(ctx, node, attrs):
    axes = attrs.get("axes")
    _set(ctx, node, ctx.sym.norm(
        ctx.inp(node.input[0]), ord=2,
        axis=tuple(axes) if axes else None,
        keepdims=bool(attrs.get("keepdims", 1)),
        name=node.name or node.output[0]))


@register_import("DepthToSpace")
def _d2s(ctx, node, attrs):
    _set(ctx, node, ctx.sym.depth_to_space(
        ctx.inp(node.input[0]), block_size=int(attrs["blocksize"]),
        name=node.name or node.output[0]))


@register_import("SpaceToDepth")
def _s2d(ctx, node, attrs):
    _set(ctx, node, ctx.sym.space_to_depth(
        ctx.inp(node.input[0]), block_size=int(attrs["blocksize"]),
        name=node.name or node.output[0]))


@register_import("Resize")
def _resize(ctx, node, attrs):
    mode = attrs.get("mode", "nearest")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if mode != "nearest":
        raise MXNetError(f"Resize import supports mode='nearest' only "
                         f"(got {mode!r})")
    scales = None
    if len(node.input) > 2 and node.input[2]:
        scales = onp.asarray(ctx.const_value(node.input[2])).reshape(-1)
    if scales is None or len(scales) != 4 or scales[2] != scales[3]:
        raise MXNetError("Resize import supports uniform HW scales only")
    if scales[0] != 1.0 or scales[1] != 1.0:
        raise MXNetError("Resize import cannot scale batch/channel dims")
    if float(scales[2]) != int(scales[2]):
        raise MXNetError(f"Resize import needs an integer HW scale "
                         f"(got {float(scales[2])})")
    _set(ctx, node, ctx.sym.UpSampling(
        ctx.inp(node.input[0]), scale=int(scales[2]),
        sample_type="nearest", name=node.name or node.output[0]))


@register_import("Constant")
def _constant(ctx, node, attrs):
    for a in node.attribute:
        if a.name == "value":
            ctx.params[node.output[0]] = _tensor_to_numpy(a.t)
            return
    raise MXNetError("Constant node without value tensor")


def _read_model(model_file):
    with open(model_file, "rb") as f:
        return O.ModelProto.FromString(f.read())


def import_model(model_file, ctx=None):
    """An ONNX file as ``(sym, arg_params, aux_params)``, the parameters
    NDArrays on ``ctx`` (default: the current context).

    Reference API: python/mxnet/contrib/onnx/onnx2mx/import_model.py."""
    return _Importer(_read_model(model_file), ctx).run()


def get_model_metadata(model_file):
    """The graph's data inputs and outputs as ``(name, shape)`` lists
    (reference: import_model.py get_model_metadata)."""
    return _metadata(_read_model(model_file))


def _metadata(model):
    g = model.graph
    inits = {t.name for t in g.initializer}

    def shapes(vis):
        out = []
        for vi in vis:
            if vi.name in inits:
                continue
            dims = tuple(d.dim_value for d in vi.type.tensor_type.shape.dim)
            out.append((vi.name, dims))
        return out

    return {"input_tensor_data": shapes(g.input),
            "output_tensor_data": shapes(g.output)}


def import_to_gluon(model_file, ctx=None):
    """An ONNX file as a ``SymbolBlock`` whose parameters hold the
    file's initializers on ``ctx`` (default: the current context)
    (reference: contrib/onnx/onnx2mx/import_to_gluon.py)."""
    from ... import symbol as _sym
    from ...gluon import SymbolBlock

    model = _read_model(model_file)
    sym, args, aux = _Importer(model, ctx).run()
    inputs = [_sym.var(n) for n, _ in _metadata(model)["input_tensor_data"]]
    net = SymbolBlock(sym, inputs)
    for name, p in net.collect_params().items():
        if name in args:
            p._load_init_from(args[name], ctx=ctx)
        elif name in aux:
            p._load_init_from(aux[name], ctx=ctx)
    return net
