"""Symbol and parameters to an ONNX file (``mx.contrib.onnx.export_model``).

The PyTorch counterpart of ``mxnet_tpu/contrib/onnx/mx2onnx.py``
(reference: python/mxnet/contrib/onnx/mx2onnx/_op_translations.py and
export_onnx.py ``MXNetGraph.create_onnx_graph_proto``): a registry of
per-op translation functions walks the symbol DAG and emits an opset-13
graph (Reshape, Clip and Dropout take tensor operands, not attributes)
through the wire codec of :mod:`._wire`, which needs no ``protobuf``.
For the same graph and parameters the file is byte for byte the JAX
package's. Initializers travel as ``raw_data``.
"""
from __future__ import annotations

import numpy as onp

from . import _wire as O
from ...base import MXNetError

_DTYPE_TO_ONNX = {"float32": O.TensorProto.FLOAT,
                  "float64": O.TensorProto.DOUBLE,
                  "float16": O.TensorProto.FLOAT16,
                  "bfloat16": O.TensorProto.BFLOAT16,
                  "uint8": O.TensorProto.UINT8,
                  "int8": O.TensorProto.INT8,
                  "int32": O.TensorProto.INT32,
                  "int64": O.TensorProto.INT64,
                  "bool": O.TensorProto.BOOL}

MX2ONNX_OPS = {}


def register_translator(*opnames):
    def deco(fn):
        for n in opnames:
            MX2ONNX_OPS[n] = fn
        return fn

    return deco


class GraphBuilder:
    def __init__(self, params):
        self.graph = O.GraphProto(name="mxnet_tpu_export")
        self.params = params  # name -> numpy
        self._initialized = set()
        self._n = 0
        # translators bump this when they emit ops newer than the
        # default opset; the model declares max(requested, min_opset)
        self.min_opset = 13

    def uniq(self, base):
        self._n += 1
        return f"{base}_{self._n}"

    def add_node(self, op_type, inputs, outputs, name=None, **attrs):
        node = self.graph.node.add(op_type=op_type,
                                   name=name or self.uniq(op_type.lower()))
        node.input.extend(inputs)
        node.output.extend(outputs)
        for k, v in attrs.items():
            if v is None:
                continue
            a = node.attribute.add(name=k)
            if isinstance(v, bool) or isinstance(v, int):
                a.type = O.AttributeProto.INT
                a.i = int(v)
            elif isinstance(v, float):
                a.type = O.AttributeProto.FLOAT
                a.f = v
            elif isinstance(v, str):
                a.type = O.AttributeProto.STRING
                a.s = v.encode()
            elif isinstance(v, (list, tuple)):
                if v and isinstance(v[0], float):
                    a.type = O.AttributeProto.FLOATS
                    a.floats.extend(v)
                else:
                    a.type = O.AttributeProto.INTS
                    a.ints.extend(int(x) for x in v)
            else:
                raise MXNetError(f"unsupported attr {k}={v!r}")
        return node

    def add_initializer(self, name, arr):
        if name in self._initialized:
            return name
        arr = onp.ascontiguousarray(arr)
        t = self.graph.initializer.add(
            name=name, data_type=_DTYPE_TO_ONNX[str(arr.dtype)])
        t.dims.extend(arr.shape)
        t.raw_data = arr.tobytes()
        self._initialized.add(name)
        return name

    def const(self, base, arr):
        return self.add_initializer(self.uniq(base), onp.asarray(arr))


def _pads(pad):
    pad = tuple(pad or ())
    return list(pad) + list(pad) if pad else None


@register_translator("convolution")
def _conv(b, name, ins, attrs):
    b.add_node("Conv", ins, [name], name=name,
               kernel_shape=list(attrs.get("kernel") or ()),
               strides=list(attrs.get("stride") or ()) or None,
               dilations=list(attrs.get("dilate") or ()) or None,
               pads=_pads(attrs.get("pad")),
               group=int(attrs.get("num_group", 1)))


@register_translator("deconvolution")
def _deconv(b, name, ins, attrs):
    b.add_node("ConvTranspose", ins, [name], name=name,
               kernel_shape=list(attrs.get("kernel") or ()),
               strides=list(attrs.get("stride") or ()) or None,
               dilations=list(attrs.get("dilate") or ()) or None,
               pads=_pads(attrs.get("pad")),
               group=int(attrs.get("num_group", 1)))


@register_translator("batch_norm")
def _bn(b, name, ins, attrs):
    if int(attrs.get("axis", 1)) != 1:
        raise MXNetError("ONNX BatchNormalization is channel-axis-1 only")
    data, gamma, beta, mean, var = ins[:5]
    if attrs.get("fix_gamma", True):
        # the op ignores gamma when fix_gamma — bake all-ones so ONNX
        # semantics match (reference _op_translations.py convert_batchnorm)
        g = b.params.get(gamma)
        shape = g.shape if g is not None else b.params[beta].shape
        gamma = b.const(gamma + "_ones", onp.ones(shape, "float32"))
    b.add_node("BatchNormalization", [data, gamma, beta, mean, var],
               [name], name=name,
               epsilon=float(attrs.get("eps", 1e-3)),
               momentum=float(attrs.get("momentum", 0.9)))


@register_translator("fully_connected")
def _fc(b, name, ins, attrs):
    data = ins[0]
    if attrs.get("flatten", True):
        flat = b.uniq(name + "_flat")
        b.add_node("Flatten", [data], [flat], axis=1)
        data = flat
    b.add_node("Gemm", [data] + list(ins[1:]), [name], name=name,
               alpha=1.0, beta=1.0, transA=0, transB=1)


@register_translator("pooling")
def _pool(b, name, ins, attrs):
    ptype = attrs.get("pool_type", "max")
    if attrs.get("global_pool", False):
        op = {"max": "GlobalMaxPool", "avg": "GlobalAveragePool"}.get(ptype)
        if op is None:
            raise MXNetError(f"no ONNX global pool for '{ptype}'")
        b.add_node(op, ins, [name], name=name)
        return
    op = {"max": "MaxPool", "avg": "AveragePool"}.get(ptype)
    if op is None:
        raise MXNetError(f"no ONNX pool for '{ptype}'")
    extra = {}
    if ptype == "avg":
        extra["count_include_pad"] = int(
            attrs.get("count_include_pad", True))
    b.add_node(op, ins, [name], name=name,
               kernel_shape=list(attrs.get("kernel") or ()),
               strides=list(attrs.get("stride") or ()) or None,
               pads=_pads(attrs.get("pad")),
               ceil_mode=int(attrs.get("pooling_convention",
                                       "valid") == "full"),
               **extra)


_ACT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
        "softrelu": "Softplus", "softsign": "Softsign"}


@register_translator("activation")
def _act(b, name, ins, attrs):
    act = attrs.get("act_type", "relu")
    if act not in _ACT:
        raise MXNetError(f"no ONNX op for act_type='{act}'")
    b.add_node(_ACT[act], ins, [name], name=name)


@register_translator("leaky_relu")
def _leaky(b, name, ins, attrs):
    act = attrs.get("act_type", "leaky")
    if act == "leaky":
        b.add_node("LeakyRelu", ins[:1], [name], name=name,
                   alpha=float(attrs.get("slope", 0.25)))
    elif act == "elu":
        b.add_node("Elu", ins[:1], [name], name=name,
                   alpha=float(attrs.get("slope", 0.25)))
    elif act == "selu":
        b.add_node("Selu", ins[:1], [name], name=name)
    elif act == "prelu":
        b.add_node("PRelu", ins[:2], [name], name=name)
    elif act == "gelu":
        # Gelu is opset-20; at opset 13 emit the exact decomposition
        # 0.5 * x * (1 + erf(x / sqrt(2)))
        x = ins[0]
        scaled = b.uniq(name + "_sc")
        rt2 = b.const(name + "_rt2", onp.float32(2.0 ** 0.5))
        b.add_node("Div", [x, rt2], [scaled])
        erfed = b.uniq(name + "_erf")
        b.add_node("Erf", [scaled], [erfed])
        one = b.const(name + "_one", onp.float32(1.0))
        shifted = b.uniq(name + "_sh")
        b.add_node("Add", [erfed, one], [shifted])
        halfx = b.uniq(name + "_hx")
        half = b.const(name + "_half", onp.float32(0.5))
        b.add_node("Mul", [x, half], [halfx])
        b.add_node("Mul", [halfx, shifted], [name], name=name)
    else:
        raise MXNetError(f"no ONNX op for leaky_relu '{act}'")


@register_translator("flatten")
def _flatten(b, name, ins, attrs):
    b.add_node("Flatten", ins, [name], name=name, axis=1)


@register_translator("concat")
def _concat(b, name, ins, attrs):
    b.add_node("Concat", ins, [name], name=name,
               axis=int(attrs.get("dim", 1)))


@register_translator("dropout")
def _dropout(b, name, ins, attrs):
    ratio = b.const(name + "_ratio",
                    onp.float32(attrs.get("p", 0.5)))
    b.add_node("Dropout", [ins[0], ratio], [name], name=name)


@register_translator("softmax")
def _softmax(b, name, ins, attrs):
    b.add_node("Softmax", ins[:1], [name], name=name,
               axis=int(attrs.get("axis", -1)))


@register_translator("log_softmax")
def _log_softmax(b, name, ins, attrs):
    b.add_node("LogSoftmax", ins[:1], [name], name=name,
               axis=int(attrs.get("axis", -1)))


@register_translator("softmax_output")
def _softmax_output(b, name, ins, attrs):
    # inference semantics: plain softmax over the class axis
    b.add_node("Softmax", ins[:1], [name], name=name, axis=-1)


@register_translator("clip")
def _clip(b, name, ins, attrs):
    lo = b.const(name + "_min", onp.float32(attrs.get("a_min", 0.0)))
    hi = b.const(name + "_max", onp.float32(attrs.get("a_max", 0.0)))
    b.add_node("Clip", [ins[0], lo, hi], [name], name=name)


@register_translator("reshape")
def _reshape(b, name, ins, attrs):
    shape = list(attrs.get("shape") or ())
    if any(s in (-2, -3, -4) for s in shape):
        raise MXNetError("reshape special codes -2/-3/-4 not exportable")
    sh = b.const(name + "_shape", onp.asarray(shape, "int64"))
    b.add_node("Reshape", [ins[0], sh], [name], name=name)


@register_translator("transpose")
def _transpose(b, name, ins, attrs):
    axes = attrs.get("axes")
    b.add_node("Transpose", ins, [name], name=name,
               perm=list(axes) if axes else None)


@register_translator("expand_dims")
def _expand_dims(b, name, ins, attrs):
    ax = b.const(name + "_axes",
                 onp.asarray([attrs.get("axis", 0)], "int64"))
    b.add_node("Unsqueeze", [ins[0], ax], [name], name=name)


@register_translator("squeeze")
def _squeeze(b, name, ins, attrs):
    axis = attrs.get("axis")
    extra = []
    if axis is not None:
        if isinstance(axis, int):
            axis = [axis]
        extra = [b.const(name + "_axes", onp.asarray(axis, "int64"))]
    b.add_node("Squeeze", [ins[0]] + extra, [name], name=name)


for _mx, _onnx in [("broadcast_add", "Add"), ("elemwise_add", "Add"),
                   ("broadcast_sub", "Sub"), ("elemwise_sub", "Sub"),
                   ("broadcast_mul", "Mul"), ("elemwise_mul", "Mul"),
                   ("broadcast_div", "Div"), ("elemwise_div", "Div"),
                   ("broadcast_maximum", "Max"),
                   ("broadcast_minimum", "Min"),
                   ("broadcast_power", "Pow"),
                   ("relu", "Relu"), ("sigmoid", "Sigmoid"),
                   ("tanh", "Tanh"), ("exp", "Exp"), ("log", "Log"),
                   ("sqrt", "Sqrt"), ("abs", "Abs"), ("negative", "Neg"),
                   ("floor", "Floor"), ("ceil", "Ceil"),
                   ("erf", "Erf"), ("add_n", "Sum"), ("dot", "MatMul"),
                   ("batch_dot", "MatMul"), ("identity", "Identity"),
                   ("BlockGrad", "Identity"), ("make_loss", "Identity")]:
    def _mk(onnx_op):
        def tr(b, name, ins, attrs):
            b.add_node(onnx_op, ins, [name], name=name)
        return tr
    register_translator(_mx)(_mk(_onnx))


def _scalar_binop(onnx_op, rev_op=None):
    def tr(b, name, ins, attrs):
        c = b.const(name + "_scalar",
                    onp.float32(attrs.get("scalar", 0.0)))
        if attrs.get("reverse", False):
            b.add_node(rev_op or onnx_op, [c, ins[0]], [name], name=name)
        else:
            b.add_node(onnx_op, [ins[0], c], [name], name=name)
    return tr


for _mx, _onnx in [("_plus_scalar", "Add"), ("_minus_scalar", "Sub"),
                   ("_mul_scalar", "Mul"), ("_div_scalar", "Div"),
                   ("_power_scalar", "Pow"),
                   ("broadcast_add_scalar", "Add"),
                   ("broadcast_sub_scalar", "Sub"),
                   ("broadcast_mul_scalar", "Mul"),
                   ("broadcast_div_scalar", "Div"),
                   ("broadcast_power_scalar", "Pow"),
                   ("maximum_scalar", "Max"),
                   ("minimum_scalar", "Min")]:
    register_translator(_mx)(_scalar_binop(_onnx))


def _reduce(onnx_op):
    # at opset 13 ReduceMean takes axes as an ATTRIBUTE (input form is
    # opset 18+); ReduceSum-13 takes an axes input
    def tr(b, name, ins, attrs):
        axis = attrs.get("axis")
        if isinstance(axis, int):
            axis = [axis]
        kw = {"keepdims": int(attrs.get("keepdims", False))}
        extra = []
        if axis is not None:
            if onnx_op == "ReduceSum":
                extra = [b.const(name + "_axes",
                                 onp.asarray(axis, "int64"))]
            else:
                kw["axes"] = [int(a) for a in axis]
        b.add_node(onnx_op, [ins[0]] + extra, [name], name=name, **kw)
    return tr


register_translator("mean")(_reduce("ReduceMean"))
register_translator("sum")(_reduce("ReduceSum"))
register_translator("max")(_reduce("ReduceMax"))
register_translator("min")(_reduce("ReduceMin"))
register_translator("prod")(_reduce("ReduceProd"))


@register_translator("lrn")
def _lrn(b, name, ins, attrs):
    b.add_node("LRN", ins, [name], name=name,
               alpha=float(attrs.get("alpha", 1e-4)),
               beta=float(attrs.get("beta", 0.75)),
               bias=float(attrs.get("knorm", 2.0)),
               size=int(attrs.get("nsize", 5)))


@register_translator("pad")
def _pad(b, name, ins, attrs):
    width = attrs.get("pad_width") or ()
    # mxnet pad_width is (before0, after0, before1, after1, ...); onnx
    # wants all-befores then all-afters
    befores = list(width[0::2])
    afters = list(width[1::2])
    pads = b.const(name + "_pads", onp.asarray(befores + afters, "int64"))
    mode = attrs.get("mode", "constant")
    b.add_node("Pad", [ins[0], pads], [name], name=name,
               mode={"constant": "constant", "edge": "edge",
                     "reflect": "reflect"}[mode])


def export_model(sym, params, input_shape, input_type="float32",
                 onnx_file_path="model.onnx", verbose=False,
                 opset_version=13):
    """Write ``sym`` (a Symbol or the path of its JSON) with ``params``
    (a dict of NDArrays or numpy arrays, or the path of a ``.params``
    file; ``arg:``/``aux:`` prefixes accepted) to ``onnx_file_path`` as an
    ONNX model of ``opset_version`` (at least what the graph's ops need).

    Reference API: python/mxnet/contrib/onnx/mx2onnx/export_model.py.
    ``input_shape``: a tuple for the single input ``data``, or a dict
    ``{input_name: shape}``. Returns ``onnx_file_path``.
    """
    from ... import ndarray as _nd
    from ... import symbol as _sym
    from ...context import cpu

    if isinstance(sym, str):
        sym = _sym.load(sym)
    if isinstance(params, str):
        params = _nd.load(params, ctx=cpu())
    nparams = {}
    for k, v in (params or {}).items():
        name = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
        nparams[name] = v.asnumpy() if hasattr(v, "asnumpy") else \
            onp.asarray(v)
    if not isinstance(input_shape, dict):
        input_shape = {"data": tuple(input_shape)}

    b = GraphBuilder(nparams)
    # topo walk with output-view dedup (same canonicalization as tojson)
    seen = {}
    order = []
    for s in sym._walk():
        if s._group:  # Group wrapper is not a graph node
            continue
        if s._name not in seen:
            seen[s._name] = s
            order.append(s)

    def tensor_name(inp):
        base = inp._name
        node = seen[base]
        if node._num_outputs == 1:
            return base
        return f"{base}_out{inp._output_index}"

    for s in order:
        if s._op is None:
            if s._name in nparams:
                b.add_initializer(s._name, nparams[s._name])
            else:
                if s._name not in input_shape:
                    raise MXNetError(
                        f"free variable '{s._name}' has neither a param "
                        "value nor an entry in input_shape")
                vi = b.graph.input.add(name=s._name)
                tt = vi.type.tensor_type
                tt.elem_type = _DTYPE_TO_ONNX[str(input_type)]
                for d in input_shape[s._name]:
                    tt.shape.dim.add(dim_value=int(d))
            continue
        tr = MX2ONNX_OPS.get(s._op)
        if tr is None:
            raise MXNetError(
                f"op '{s._op}' has no ONNX translation "
                f"(reference parity list: _op_translations.py)")
        ins = [tensor_name(i) for i in s._inputs]
        if s._num_outputs == 1:
            tr(b, s._name, ins, s._kwargs)
        else:
            outs = [f"{s._name}_out{i}" for i in range(s._num_outputs)]
            tr_multi = getattr(tr, "multi", None)
            if tr_multi is None:
                raise MXNetError(
                    f"multi-output op '{s._op}' not exportable")
            tr_multi(b, s._name, ins, s._kwargs, outs)
        if verbose:
            print(f"[mx2onnx] {s._op} -> {s._name}")

    heads = sym._group or [sym]
    for h in heads:
        out = b.graph.output.add(name=tensor_name(h))
        out.type.tensor_type.elem_type = _DTYPE_TO_ONNX[str(input_type)]

    model = O.ModelProto(ir_version=7, producer_name="mxnet_tpu",
                         producer_version="3.0", graph=b.graph)
    model.opset_import.add(domain="",
                           version=max(opset_version, b.min_opset))
    with open(onnx_file_path, "wb") as f:
        f.write(model.SerializeToString())
    return onnx_file_path


# ---- the reference _op_translations.py tail ---------------------------------

for _mx, _onnx in [("sin", "Sin"), ("cos", "Cos"), ("tan", "Tan"),
                   ("arcsin", "Asin"), ("arccos", "Acos"),
                   ("arctan", "Atan"), ("sinh", "Sinh"), ("cosh", "Cosh"),
                   ("round", "Round"), ("sign", "Sign"),
                   ("reciprocal", "Reciprocal"),
                   ("depth_to_space", "DepthToSpace"),
                   ("space_to_depth", "SpaceToDepth")]:
    def _mk2(onnx_op):
        def tr(b, name, ins, attrs):
            kw = {}
            if onnx_op in ("DepthToSpace", "SpaceToDepth"):
                kw["blocksize"] = int(attrs.get("block_size", 2))
            b.add_node(onnx_op, ins, [name], name=name, **kw)
        return tr
    register_translator(_mx)(_mk2(_onnx))


@register_translator("where")
def _where_exp(b, name, ins, attrs):
    # mx conditions are float 0/1 masks; ONNX Where requires bool
    cond = b.uniq(name + "_cond")
    b.add_node("Cast", [ins[0]], [cond], to=int(O.TensorProto.BOOL))
    b.add_node("Where", [cond] + list(ins[1:]), [name], name=name)


@register_translator("gather_nd")
def _gather_nd_exp(b, name, ins, attrs):
    """mx gather_nd indices are (M, d1..dk) — index tuple on the LEADING
    axis; ONNX GatherND wants it on the LAST. The inserted full-reverse
    Transpose maps between them exactly for the rank-2 indices case
    (the only layout this exporter supports; reference
    _op_translations.py transposes the same way)."""
    idx = b.uniq(name + "_idxT")
    b.add_node("Transpose", [ins[1]], [idx])
    idx64 = b.uniq(name + "_idx64")
    b.add_node("Cast", [idx], [idx64], to=int(O.TensorProto.INT64))
    b.add_node("GatherND", [ins[0], idx64], [name], name=name)
    b.min_opset = max(b.min_opset, 12)


def _cmp_export(onnx_op):
    """mx comparisons return float 0/1 masks; ONNX returns bool — Cast
    back to float32 to keep graph semantics identical."""
    def tr(b, name, ins, attrs):
        raw = b.uniq(name + "_bool")
        b.add_node(onnx_op, ins, [raw])
        b.add_node("Cast", [raw], [name], name=name,
                   to=int(O.TensorProto.FLOAT))
    return tr


for _mx, _onnx in [("broadcast_greater", "Greater"),
                   ("broadcast_lesser", "Less"),
                   ("broadcast_equal", "Equal"),
                   ("broadcast_greater_equal", "GreaterOrEqual"),
                   ("broadcast_lesser_equal", "LessOrEqual"),
                   ("broadcast_not_equal", "Equal")]:
    if _mx == "broadcast_not_equal":
        def _ne(b, name, ins, attrs):
            eq = b.uniq(name + "_eq")
            b.add_node("Equal", ins, [eq])
            nb = b.uniq(name + "_not")
            b.add_node("Not", [eq], [nb])
            b.add_node("Cast", [nb], [name], name=name,
                       to=int(O.TensorProto.FLOAT))
        register_translator(_mx)(_ne)
    else:
        register_translator(_mx)(_cmp_export(_onnx))
# GreaterOrEqual/LessOrEqual exist from opset 12 (covered by default 13)


@register_translator("slice_axis")
def _slice_axis(b, name, ins, attrs):
    axis = int(attrs["axis"])
    begin = int(attrs.get("begin", 0) or 0)
    end = attrs.get("end")
    end = int(end) if end is not None else (2 ** 31 - 1)
    b.add_node("Slice",
               [ins[0], b.const(name + "_starts", onp.asarray([begin], "int64")),
                b.const(name + "_ends", onp.asarray([end], "int64")),
                b.const(name + "_axes", onp.asarray([axis], "int64"))],
               [name], name=name)


@register_translator("slice")
def _slice(b, name, ins, attrs):
    begin = [0 if v is None else int(v) for v in attrs.get("begin", ())]
    end = [(2 ** 31 - 1) if v is None else int(v)
           for v in attrs.get("end", ())]
    axes = list(range(len(begin)))
    extra = [b.const(name + "_starts", onp.asarray(begin, "int64")),
             b.const(name + "_ends", onp.asarray(end, "int64")),
             b.const(name + "_axes", onp.asarray(axes, "int64"))]
    step = attrs.get("step")
    if step:
        extra.append(b.const(name + "_steps", onp.asarray(
            [1 if v is None else int(v) for v in step], "int64")))
    b.add_node("Slice", [ins[0]] + extra, [name], name=name)


@register_translator("split")
def _split(b, name, ins, attrs):
    b.add_node("Split", ins, [name], name=name,
               axis=int(attrs.get("axis", 1)))


def _split_multi(b, name, ins, attrs, outs):
    b.add_node("Split", ins, outs, name=name,
               axis=int(attrs.get("axis", 1)))


_split.multi = _split_multi


@register_translator("embedding")
def _embedding(b, name, ins, attrs):
    idx = b.uniq(name + "_idx")
    b.add_node("Cast", [ins[0]], [idx], to=int(O.TensorProto.INT64))
    b.add_node("Gather", [ins[1], idx], [name], name=name, axis=0)


@register_translator("take")
def _take(b, name, ins, attrs):
    idx = b.uniq(name + "_idx")
    b.add_node("Cast", [ins[1]], [idx], to=int(O.TensorProto.INT64))
    b.add_node("Gather", [ins[0], idx], [name], name=name,
               axis=int(attrs.get("axis", 0)))


@register_translator("cast")
def _cast(b, name, ins, attrs):
    b.add_node("Cast", ins, [name], name=name,
               to=int(_DTYPE_TO_ONNX[str(attrs.get("dtype", "float32"))]))


@register_translator("tile")
def _tile(b, name, ins, attrs):
    reps = attrs.get("reps") or attrs.get("reps_", ())
    b.add_node("Tile",
               [ins[0], b.const(name + "_reps",
                                onp.asarray(list(reps), "int64"))],
               [name], name=name)


@register_translator("broadcast_to")
def _broadcast_to(b, name, ins, attrs):
    b.add_node("Expand",
               [ins[0], b.const(name + "_shape", onp.asarray(
                   list(attrs.get("shape", ())), "int64"))],
               [name], name=name)


@register_translator("shape_array")
def _shape_array(b, name, ins, attrs):
    b.add_node("Shape", ins, [name], name=name)


@register_translator("one_hot")
def _one_hot(b, name, ins, attrs):
    depth = int(attrs["depth"])
    on = float(attrs.get("on_value", 1.0))
    off = float(attrs.get("off_value", 0.0))
    idx = b.uniq(name + "_idx")
    b.add_node("Cast", [ins[0]], [idx], to=int(O.TensorProto.INT64))
    b.add_node("OneHot",
               [idx, b.const(name + "_depth", onp.asarray(depth, "int64")),
                b.const(name + "_vals", onp.asarray([off, on], "float32"))],
               [name], name=name, axis=-1)


@register_translator("argmax")
def _argmax(b, name, ins, attrs):
    raw = b.uniq(name + "_i64")
    axis = attrs.get("axis")
    data = ins[0]
    if axis is None:
        # axis=None flattens first (mx semantics: one flat index)
        flat = b.uniq(name + "_flat")
        b.add_node("Reshape",
                   [data, b.const(name + "_m1",
                                  onp.asarray([-1], "int64"))], [flat])
        data, axis = flat, 0
    b.add_node("ArgMax", [data], [raw], axis=int(axis),
               keepdims=int(attrs.get("keepdims", False)))
    b.add_node("Cast", [raw], [name], name=name,
               to=int(O.TensorProto.FLOAT))


@register_translator("argmin")
def _argmin(b, name, ins, attrs):
    raw = b.uniq(name + "_i64")
    axis = attrs.get("axis")
    data = ins[0]
    if axis is None:
        # axis=None flattens first (mx semantics: one flat index)
        flat = b.uniq(name + "_flat")
        b.add_node("Reshape",
                   [data, b.const(name + "_m1",
                                  onp.asarray([-1], "int64"))], [flat])
        data, axis = flat, 0
    b.add_node("ArgMin", [data], [raw], axis=int(axis),
               keepdims=int(attrs.get("keepdims", False)))
    b.add_node("Cast", [raw], [name], name=name,
               to=int(O.TensorProto.FLOAT))


@register_translator("topk")
def _topk(b, name, ins, attrs):
    raise MXNetError("ONNX TopK exports ret_typ='both' only")


def _topk_multi(b, name, ins, attrs, outs):
    if attrs.get("ret_typ", "indices") != "both":
        raise MXNetError("ONNX TopK exports ret_typ='both' only")
    k = int(attrs.get("k", 1))
    axis = int(attrs.get("axis", -1))
    idx_raw = b.uniq(name + "_idx64")
    b.add_node("TopK",
               [ins[0], b.const(name + "_k", onp.asarray([k], "int64"))],
               [outs[0], idx_raw], name=name, axis=axis,
               largest=int(not attrs.get("is_ascend", False)))
    b.add_node("Cast", [idx_raw], [outs[1]],
               to=int(O.TensorProto.FLOAT))


_topk.multi = _topk_multi


@register_translator("layer_norm")
def _layer_norm(b, name, ins, attrs):
    b.add_node("LayerNormalization", ins[:3], [name], name=name,
               axis=int(attrs.get("axis", -1)),
               epsilon=float(attrs.get("eps", 1e-5)))
    b.min_opset = max(b.min_opset, 17)  # LayerNormalization: opset >=17


@register_translator("instance_norm")
def _instance_norm(b, name, ins, attrs):
    b.add_node("InstanceNormalization", ins[:3], [name], name=name,
               epsilon=float(attrs.get("eps", 1e-3)))


@register_translator("norm")
def _norm(b, name, ins, attrs):
    ordv = int(attrs.get("ord", 2))
    axis = attrs.get("axis")
    kw = {"keepdims": int(attrs.get("keepdims", False))}
    if axis is not None:
        kw["axes"] = [axis] if isinstance(axis, int) else list(axis)
    op = {1: "ReduceL1", 2: "ReduceL2"}.get(ordv)
    if op is None:
        raise MXNetError(f"ONNX export supports norm ord 1/2, got {ordv}")
    b.add_node(op, ins, [name], name=name, **kw)


@register_translator("upsampling")
def _upsampling(b, name, ins, attrs):
    scale = float(attrs.get("scale", 2))
    b.add_node("Resize",
               [ins[0], b.const(name + "_roi", onp.asarray([], "float32")),
                b.const(name + "_scales",
                        onp.asarray([1.0, 1.0, scale, scale], "float32"))],
               [name], name=name, mode="nearest")


@register_translator("stack")
def _stack(b, name, ins, attrs):
    axis = int(attrs.get("axis", 0))
    unsq = []
    for i, x in enumerate(ins):
        u = b.uniq(f"{name}_u{i}")
        b.add_node("Unsqueeze",
                   [x, b.const(f"{name}_ax{i}",
                               onp.asarray([axis], "int64"))], [u])
        unsq.append(u)
    b.add_node("Concat", unsq, [name], name=name, axis=axis)
