"""ONNX interchange of the PyTorch port against the JAX package's, on the
CPU (``mxnet_tpu_torch/contrib/onnx`` against ``mxnet_tpu/contrib/onnx``).

- The codec: the port's wire codec (``_wire.py``) writes the bytes the
  JAX package's protobuf messages (``onnx_pb2``) write, and reads what
  they write, unknown fields skipped.
- The exporter: for the vision zoo's families that the JAX test
  (``tests/test_onnx.py``) runs outside its slow lane, at ``classes=10``
  and 224 x 224, the same weights (made by the port from a numpy seed,
  carried into the JAX net by structural name, explicit ``prefix=``)
  exported by each package give byte-equal files, which the JAX
  package's ``onnx_pb2`` parses. Hand-built symbols are made under a fresh
  ``NameManager`` in each package so their op names agree.
- The importers: each package's importer reads the other's file, and
  the imported graph's outputs agree with the exporting graph's within
  the JAX test's rtol 1e-4 / atol 1e-4 (its own bounds where it set
  tighter ones); ``get_model_metadata`` and ``import_to_gluon`` agree.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import symbol as jsym
from mxnet_tpu.contrib import onnx as jonnx
from mxnet_tpu.contrib.onnx import onnx_pb2
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.contrib.onnx import _wire
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
RTOL = ATOL = 1e-4

# the zoo families of tests/test_onnx.py that are not marked slow
FAMILIES = ["resnet18_v1", "resnet18_v2", "mobilenet_v2_0_25",
            "mobilenet0_25", "squeezenet1_0", "alexnet"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two threads for the port's CPU convolutions, so this file leaves
    the other workers of a parallel run their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _host(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _carry(block_t, block_j):
    """The port block's weights into the JAX block, by structural name."""
    jp = block_j._collect_params_with_prefix()
    tp = _host(block_t)
    assert sorted(jp) == sorted(tp)
    for k, v in tp.items():
        jp[k]._load_init_from(jnd.array(v))


def _stats(net, rs):
    """Running statistics off their initial zeros and ones, so the
    exported aux states are seen to travel."""
    for k, p in sorted(net._collect_params_with_prefix().items()):
        if k.endswith("running_mean"):
            p.set_data(rs.uniform(-0.1, 0.1, p.shape).astype("float32"))
        elif k.endswith("running_var"):
            p.set_data(rs.uniform(0.5, 1.5, p.shape).astype("float32"))


def _export_both(tnet, tpath, jnet, jpath):
    """Each block's ``export`` under a fresh NameManager of its package:
    the traced op names (``convolution0``, ...) then do not depend on
    the counters that earlier tests in the process advanced."""
    with mx.name.NameManager():
        tnet.export(tpath)
    with jmx.name.NameManager():
        jnet.export(jpath)


def _bind_forward(pkg_mx, s, args, aux, feed, ctx):
    full = dict(feed)
    full.update(args)
    ex = s.bind(ctx, full, aux_states=aux)
    return [o.asnumpy() for o in ex.forward()]


def _close(got, want, rtol=RTOL, atol=ATOL):
    onp.testing.assert_allclose(onp.asarray(got, dtype="float64"),
                                onp.asarray(want, dtype="float64"),
                                rtol=rtol, atol=atol)


# -- the codec ---------------------------------------------------------------

def _build_model(O):
    g = O.GraphProto(name="g")
    n = g.node.add(op_type="Conv", name="c")
    n.input.extend(["x", "w"])
    n.output.extend(["y"])
    for k, v in [("i", 7), ("zero", 0), ("neg", -5), ("f", 0.1),
                 ("f0", 0.0), ("fneg0", -0.0), ("s", "same"),
                 ("ints", [1, -2, 300]), ("floats", [0.5, -1e-3])]:
        a = n.attribute.add(name=k)
        if isinstance(v, int):
            a.type = O.AttributeProto.INT
            a.i = v
        elif isinstance(v, float):
            a.type = O.AttributeProto.FLOAT
            a.f = v
        elif isinstance(v, str):
            a.type = O.AttributeProto.STRING
            a.s = v.encode()
        elif isinstance(v[0], float):
            a.type = O.AttributeProto.FLOATS
            a.floats.extend(v)
        else:
            a.type = O.AttributeProto.INTS
            a.ints.extend(v)
    rs = onp.random.RandomState(3)
    for name, arr in [("w", rs.rand(3, 4).astype("float32")),
                      ("k", onp.asarray([-1, 2 ** 40], "int64")),
                      ("empty", onp.zeros((0,), "float32")),
                      ("scalar", onp.float32(2.5))]:
        arr = onp.asarray(arr)
        t = g.initializer.add(name=name, data_type={
            "float32": O.TensorProto.FLOAT,
            "int64": O.TensorProto.INT64}[str(arr.dtype)])
        t.dims.extend(arr.shape)
        t.raw_data = arr.tobytes()
    t = g.initializer.add(name="listed", data_type=O.TensorProto.FLOAT)
    t.dims.extend([2])
    t.float_data.extend([1.5, -2.0])
    vi = g.input.add(name="x")
    tt = vi.type.tensor_type
    tt.elem_type = O.TensorProto.FLOAT
    for d in (0, 3, 224):
        tt.shape.dim.add(dim_value=d)
    g.input.add(name="unshaped").type.tensor_type.elem_type = 1
    out = g.output.add(name="y")
    out.type.tensor_type.elem_type = O.TensorProto.FLOAT
    model = O.ModelProto(ir_version=7, producer_name="mxnet_tpu",
                         producer_version="3.0", graph=g)
    model.opset_import.add(domain="", version=13)
    return model


def test_wire_codec_writes_and_reads_protobufs_bytes():
    ref = _build_model(onnx_pb2).SerializeToString()
    got = _build_model(_wire).SerializeToString()
    assert got == ref
    back = _wire.ModelProto.FromString(ref)
    assert back.SerializeToString() == ref
    node = back.graph.node[0]
    assert [a.name for a in node.attribute][:3] == ["i", "zero", "neg"]
    assert node.attribute[2].i == -5
    assert list(node.attribute[7].ints) == [1, -2, 300]
    assert back.graph.input[0].type.tensor_type.shape.dim[0].HasField(
        "dim_value")
    w = back.graph.initializer[0]
    assert onp.frombuffer(w.raw_data, "float32").reshape(tuple(w.dims)) \
        .tobytes() == onp.random.RandomState(3).rand(3, 4) \
        .astype("float32").tobytes()
    assert list(back.graph.initializer[4].float_data) == [1.5, -2.0]


def test_wire_codec_skips_unknown_fields_and_reads_unpacked_numerics():
    """A field of a newer schema (ModelProto 15, a string; GraphProto 99,
    a varint) is skipped; ``ints`` written one record each (proto2's
    unpacked form) reads as the packed list."""
    model = _wire.ModelProto(ir_version=7)
    model.graph.node.add(op_type="Relu")
    body = model.SerializeToString()
    graph = model.graph.SerializeToString()
    unknown_graph = graph + bytes([99 << 3 & 0x7F | 0x80, 99 >> 4, 0x05])
    attr = b"\x0a\x01a" + b"\xa0\x01\x07" + b"\x40\x01\x40\x02"
    node = b"\x22\x04Relu" + b"\x2a" + bytes([len(attr)]) + attr
    unknown_graph += b"\x0a" + bytes([len(node)]) + node
    data = (b"\x08\x07" + bytes([15 << 3 | 2, 3]) + b"new" + b"\x3a"
            + bytes([len(unknown_graph)]) + unknown_graph)
    for parse in (_wire.ModelProto.FromString,
                  onnx_pb2.ModelProto.FromString):
        m = parse(data)
        assert m.ir_version == 7
        assert [n.op_type for n in m.graph.node] == ["Relu", "Relu"]
        assert list(m.graph.node[1].attribute[0].ints) == [1, 2]
    assert body.startswith(b"\x08\x07")


# -- the exporter and both importers on the zoo ------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_zoo_family_export_is_byte_equal_and_round_trips(name, tmp_path):
    shape = (1, 3, 224, 224)
    mx.random.seed(0)
    rs = onp.random.RandomState(7)
    x = rs.rand(*shape).astype("float32")
    tnet = vision.get_model(name, classes=10, prefix="net_")
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    _stats(tnet, rs)
    jnet = jvision.get_model(name, classes=10, prefix="net_")
    _carry(tnet, jnet)
    tref = tnet(nd.array(x, ctx=CPU)).asnumpy()
    jref = jnet(jnd.array(x)).asnumpy()

    _export_both(tnet, str(tmp_path / "t"), jnet, str(tmp_path / "j"))
    tfile = tonnx.export_model(
        str(tmp_path / "t-symbol.json"), str(tmp_path / "t-0000.params"),
        shape, onnx_file_path=str(tmp_path / "t.onnx"))
    jfile = jonnx.export_model(
        str(tmp_path / "j-symbol.json"), str(tmp_path / "j-0000.params"),
        shape, onnx_file_path=str(tmp_path / "j.onnx"))
    tbytes = _read(tfile)
    assert tbytes == _read(jfile)
    parsed = onnx_pb2.ModelProto.FromString(tbytes)
    assert parsed.SerializeToString() == tbytes
    assert {t.name for t in parsed.graph.initializer} >= {
        p.name for p in tnet.collect_params().values()}

    # the port's importer on the JAX file, bound through the Executor
    s, args, aux = tonnx.import_model(jfile, ctx=CPU)
    (tout,) = _bind_forward(mx, s, args, aux,
                            {"data": nd.array(x, ctx=CPU)}, CPU)
    _close(tout, jref)
    _close(tout, tref, rtol=1e-5, atol=1e-5)
    # the JAX importer on the port's file
    s, args, aux = jonnx.import_model(tfile)
    (jout,) = _bind_forward(jmx, s, args, aux, {"data": jnd.array(x)},
                            jmx.cpu())
    _close(jout, tref)


def test_import_to_gluon_and_metadata_agree(tmp_path):
    """``import_to_gluon`` (twin of the JAX test_import_to_gluon) gives a
    SymbolBlock whose parameters sit on the context asked for; eager and
    hybridized it answers as the source block; ``get_model_metadata``
    equals the JAX package's (twin of test_onnx_metadata)."""
    shape = (2, 3, 224, 224)
    mx.random.seed(1)
    rs = onp.random.RandomState(7)
    x = rs.rand(*shape).astype("float32")
    tnet = vision.mobilenet0_25(classes=10, prefix="m_")
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    _stats(tnet, rs)
    ref = tnet(nd.array(x, ctx=CPU)).asnumpy()
    tnet.export(str(tmp_path / "g"))
    f = tonnx.export_model(str(tmp_path / "g-symbol.json"),
                           str(tmp_path / "g-0000.params"), shape,
                           onnx_file_path=str(tmp_path / "g.onnx"))
    meta = tonnx.get_model_metadata(f)
    assert meta == jonnx.get_model_metadata(f)
    assert meta["input_tensor_data"] == [("data", shape)]
    assert len(meta["output_tensor_data"]) == 1
    net2 = tonnx.import_to_gluon(f, ctx=CPU)
    for p in net2.collect_params().values():
        assert p.data().context == CPU
    _close(net2(nd.array(x, ctx=CPU)).asnumpy(), ref, rtol=1e-5, atol=1e-5)
    net2.hybridize()
    _close(net2(nd.array(x, ctx=CPU)).asnumpy(), ref, rtol=1e-5, atol=1e-5)
    jnet2 = jonnx.import_to_gluon(f)
    _close(jnet2(jnd.array(x)).asnumpy(), ref)


# -- hand-built graphs and small blocks (twins of tests/test_onnx.py) ---------

def _both_symbols(build, feed, in_shapes, tmp_path, tag, extra=None,
                  rtol=1e-5, atol=1e-5):
    """``build(sym)`` in each package under a fresh NameManager, exported
    by each: the files are byte-equal, and each importer's graph answers
    as the exporting package's graph within the bounds."""
    with jmx.name.NameManager():
        js = build(jsym)
    with mx.name.NameManager():
        ts = build(tsym)
    extra = extra or {}
    jfile = jonnx.export_model(
        js, {k: jnd.array(v) for k, v in extra.items()}, in_shapes,
        onnx_file_path=str(tmp_path / f"{tag}-j.onnx"))
    tfile = tonnx.export_model(
        ts, {k: nd.array(v, ctx=CPU) for k, v in extra.items()}, in_shapes,
        onnx_file_path=str(tmp_path / f"{tag}-t.onnx"))
    assert _read(tfile) == _read(jfile), tag
    onnx_pb2.ModelProto.FromString(_read(tfile))
    jfeed = {k: jnd.array(v) for k, v in feed.items()}
    tfeed = {k: nd.array(v, ctx=CPU) for k, v in feed.items()}
    jref = js.eval_with(dict(jfeed))
    tref = ts.eval_with(dict(tfeed))

    def outs(v):
        return [o.asnumpy() for o in
                (v if isinstance(v, (list, tuple)) else [v])]

    s, args, aux = tonnx.import_model(jfile, ctx=CPU)
    full = dict(tfeed)
    full.update(args)
    full.update(aux)
    for g, r in zip(outs(s.eval_with(full)), outs(jref)):
        _close(g, r, rtol=rtol, atol=atol)
    s, args, aux = jonnx.import_model(tfile)
    full = dict(jfeed)
    full.update(args)
    full.update(aux)
    for g, r in zip(outs(s.eval_with(full)), outs(tref)):
        _close(g, r, rtol=rtol, atol=atol)
    return tfile


def _both_blocks(make, shape, tmp_path, tag):
    """A small Gluon block made in each package (explicit prefix), the
    port's weights carried into the JAX one, exported by each: byte-equal
    files, and each importer's Executor within 1e-4 of the other
    package's block."""
    mx.random.seed(2)
    rs = onp.random.RandomState(2)
    x = rs.rand(*shape).astype("float32")
    tnet = make(nn, "blk_")
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    jnet = make(jnn, "blk_")
    _carry(tnet, jnet)
    tref = tnet(nd.array(x, ctx=CPU)).asnumpy()
    jref = jnet(jnd.array(x)).asnumpy()
    _export_both(tnet, str(tmp_path / f"{tag}t"), jnet,
                 str(tmp_path / f"{tag}j"))
    tfile = tonnx.export_model(
        str(tmp_path / f"{tag}t-symbol.json"),
        str(tmp_path / f"{tag}t-0000.params"), shape,
        onnx_file_path=str(tmp_path / f"{tag}t.onnx"))
    jfile = jonnx.export_model(
        str(tmp_path / f"{tag}j-symbol.json"),
        str(tmp_path / f"{tag}j-0000.params"), shape,
        onnx_file_path=str(tmp_path / f"{tag}j.onnx"))
    assert _read(tfile) == _read(jfile), tag
    s, args, aux = tonnx.import_model(jfile, ctx=CPU)
    (tout,) = _bind_forward(mx, s, args, aux,
                            {"data": nd.array(x, ctx=CPU)}, CPU)
    _close(tout, jref)
    s, args, aux = jonnx.import_model(tfile)
    (jout,) = _bind_forward(jmx, s, args, aux, {"data": jnd.array(x)},
                            jmx.cpu())
    _close(jout, tref)


def test_onnx_mlp_ops(tmp_path):
    def make(pkg_nn, prefix):
        net = pkg_nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(pkg_nn.Dense(16, activation="tanh"),
                    pkg_nn.Dropout(0.2), pkg_nn.Dense(4))
        return net

    _both_blocks(make, (3, 8), tmp_path, "mlp")


def test_onnx_r5_norm_layers(tmp_path):
    def dense_ln(pkg_nn, prefix):
        net = pkg_nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(pkg_nn.Dense(12), pkg_nn.LayerNorm())
        return net

    def conv_in(pkg_nn, prefix):
        net = pkg_nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(pkg_nn.Conv2D(4, 3, padding=1), pkg_nn.InstanceNorm(),
                    pkg_nn.Activation("relu"))
        return net

    _both_blocks(dense_ln, (2, 8), tmp_path, "ln")
    _both_blocks(conv_in, (2, 3, 8, 8), tmp_path, "in")


def test_onnx_reduce_gelu_group(tmp_path):
    def build(S):
        a = S.Variable("data")
        return S.Group([S.mean(a, axis=1, keepdims=True), S.sum(a, axis=0),
                        S.leaky_relu(a, act_type="gelu")])

    A = onp.random.RandomState(7).rand(3, 5).astype("float32")
    _both_symbols(build, {"data": A}, (3, 5), tmp_path, "rg", rtol=1e-4)


def test_onnx_symbol_level_ops(tmp_path):
    def build(S):
        a = S.Variable("data")
        out = S.broadcast_add(S.transpose(a * 2.0 + 1.0), a * 1.0)
        return S.reshape(out, shape=(-1,))

    A = onp.random.RandomState(7).rand(4, 4).astype("float32")
    _both_symbols(build, {"data": A}, (4, 4), tmp_path, "sl")


def test_onnx_r5_indexing_ops(tmp_path):
    A = onp.random.RandomState(7).rand(4, 6).astype("float32")
    B = onp.random.RandomState(8).rand(1, 6).astype("float32")
    cases = [
        ("sl", lambda S: S.slice(S.Variable("data"), begin=(1, 0),
                                 end=(3, 4)), {"data": A}, (4, 6)),
        ("sa", lambda S: S.slice_axis(S.Variable("data"), axis=1, begin=2,
                                      end=5), {"data": A}, (4, 6)),
        ("ti", lambda S: S.tile(S.Variable("data"), reps=(2, 1)),
         {"data": A}, (4, 6)),
        ("sp", lambda S: S.Group(list(S.split(S.Variable("data"),
                                              num_outputs=2, axis=1))),
         {"data": A}, (4, 6)),
        ("tk", lambda S: S.take(S.Variable("data"), S.Variable("idx"),
                                axis=0),
         {"data": A, "idx": onp.array([0., 2., 1.], "float32")},
         {"data": (4, 6), "idx": (3,)}),
        ("bt", lambda S: S.broadcast_to(S.Variable("b"), shape=(4, 6)),
         {"b": B}, {"b": (1, 6)}),
        ("st", lambda S: S.stack(S.Variable("data"),
                                 S.Variable("data") * 2.0, axis=0),
         {"data": A}, (4, 6)),
    ]
    for tag, build, feed, shapes in cases:
        _both_symbols(build, feed, shapes, tmp_path, tag)


def test_onnx_r5_compare_where_onehot(tmp_path):
    rs = onp.random.RandomState(7)
    feed = {"data": rs.rand(3, 4).astype("float32"),
            "b": rs.rand(3, 4).astype("float32")}
    shapes = {"data": (3, 4), "b": (3, 4)}
    cases = [
        ("gt", lambda S: S.broadcast_greater(S.Variable("data"),
                                             S.Variable("b"))),
        ("ne", lambda S: S.broadcast_not_equal(S.Variable("data"),
                                               S.Variable("b"))),
        ("wh", lambda S: S.where(S.broadcast_greater(S.Variable("data"),
                                                     S.Variable("b")),
                                 S.Variable("data"), S.Variable("b"))),
    ]
    for tag, build in cases:
        _both_symbols(build, feed, shapes, tmp_path, tag)
    _both_symbols(lambda S: S.one_hot(S.Variable("lbl"), depth=5),
                  {"lbl": onp.array([0., 3., 2.], "float32")},
                  {"lbl": (3,)}, tmp_path, "oh")


def test_onnx_r5_math_norm_argmax(tmp_path):
    A = (onp.random.RandomState(7).rand(3, 5).astype("float32") - 0.3)
    feed = {"data": A}
    for op in ("sin", "cos", "round", "sign", "reciprocal", "arctan"):
        _both_symbols(lambda S, op=op: getattr(S, op)(S.Variable("data")),
                      feed, (3, 5), tmp_path, op, rtol=1e-4)
    _both_symbols(lambda S: S.norm(S.Variable("data"), ord=2, axis=1),
                  feed, (3, 5), tmp_path, "l2")
    _both_symbols(lambda S: S.argmax(S.Variable("data"), axis=1),
                  feed, (3, 5), tmp_path, "am")
    _both_symbols(lambda S: S.cast(S.Variable("data"), dtype="int32"),
                  feed, (3, 5), tmp_path, "ct")

    def topk(S):
        both = S.topk(S.Variable("data"), k=2, axis=1, ret_typ="both")
        return S.Group([both[0], both[1]])

    _both_symbols(topk, feed, (3, 5), tmp_path, "tkk")


def test_onnx_r5_embedding_gather(tmp_path):
    W = onp.random.RandomState(7).rand(10, 4).astype("float32")

    def build(S):
        return S.Embedding(S.Variable("data"), S.Variable("w"),
                           input_dim=10, output_dim=4)

    _both_symbols(build, {"data": onp.array([1., 4., 7.], "float32"),
                          "w": W}, {"data": (3,)}, tmp_path, "em",
                  extra={"w": W})


def test_unknown_op_raises_and_names_it(tmp_path):
    """The exporter refuses an op without a translation, and the importer
    an ONNX op without one, in both packages alike."""
    for S, exp in ((tsym, tonnx), (jsym, jonnx)):
        s = S.log1p(S.Variable("data"))
        with pytest.raises(Exception, match="log1p"):
            exp.export_model(s, {}, (2, 2),
                             onnx_file_path=str(tmp_path / "x.onnx"))
    model = _wire.ModelProto(ir_version=7)
    model.graph.node.add(op_type="Einsum", input=["data"], output=["y"])
    model.graph.input.add(name="data")
    model.graph.output.add(name="y")
    path = str(tmp_path / "einsum.onnx")
    with open(path, "wb") as f:
        f.write(model.SerializeToString())
    for imp in (tonnx, jonnx):
        with pytest.raises(Exception, match="Einsum"):
            imp.import_model(path)
    assert os.path.getsize(path) > 0


# -- the slice as a whole (tools/profile_onnx.py, chip_smoke phases 69-72) --

def test_fit_export_import_store_flow_on_the_cpu(tmp_path):
    """The card's flow at a toy size: ``Estimator.fit`` (logging,
    checkpoint, early stopping, a monitor every 2 steps) bitwise equal to
    the loop written by hand from the same start; the exported
    initializers bitwise the parameters; ``import_to_gluon`` and the
    Executor over ``import_model`` within 1e-5 of the trained block (here
    exactly), the JAX importer within 1e-4; ``pretrained=True`` through
    the store bitwise."""
    from mxnet_tpu_torch.tools import profile_onnx as po

    kw = dict(name="resnet18_v1", classes=10)
    net, start = po.build(CPU, 0, size=32, **kw)
    hand = po.twin(CPU, start, **kw)
    net.hybridize()
    hand.hybridize()
    data = po.batches(CPU, 1, n=2, batch=4, size=32, classes=10)
    f = po.fit(net, data, CPU, str(tmp_path), epochs=2, interval=2)
    h = po.hand_loop(hand, data, CPU, epochs=2, interval=2)
    assert po.same_parameters(net, hand) == []
    assert po.same_parameters(net, po.twin(CPU, start, **kw)) != []
    assert len(f["step_ms"]) == len(h["step_ms"]) == 4
    assert [r[:2] for r in f["monitor_rows"]] == \
        [r[:2] for r in h["monitor_rows"]]
    assert sorted({r[0] for r in f["monitor_rows"]}) == [1, 3]
    assert f["checkpoints"] == [f"{po.NAME}-epoch1.params",
                                f"{po.NAME}-epoch2.params"]
    assert f["log_lines"][0] == "Training begin"
    assert f["log_lines"][-1].startswith("Train finished in ")
    path, params_file, model, info = po.export(net, str(tmp_path),
                                               (4, 3, 32, 32))
    assert po.check_initializers(model, net) == len(net.collect_params())
    assert info["nodes"] == len(model.graph.node) > 0
    x = data[0][0]
    ref = net(x).asnumpy()
    _, g, e, _ = po.import_both(path, CPU, x)
    _close(g, ref, rtol=1e-5, atol=1e-5)
    _close(e, ref, rtol=1e-5, atol=1e-5)
    s, args, aux = jonnx.import_model(path)
    (jout,) = _bind_forward(jmx, s, args, aux, {"data": jnd.array(
        x.asnumpy())}, jmx.cpu())
    _close(jout, ref)
    stored = po.store_load(params_file, str(tmp_path / "models"), CPU, **kw)
    stored.hybridize()
    assert stored(x).asnumpy().tobytes() == ref.tobytes()
