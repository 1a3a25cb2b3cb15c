"""Symbol graphs and nd.save/load: the port against the JAX package.

The graph is a small wav2vec2 CTC (``mxnet_tpu_torch/tools/
profile_predict.py``: 3 conv layers of width 32, hidden 64, 2 layers, 4
heads, a 16-tap positional conv in 4 groups), built call for call by
``wav2vec2_symbol`` over each package's ``sym``; its weights are drawn
with numpy from a seed and handed to both.

- JSON: the JAX package's ``tojson`` loads in the port and is written
  back unchanged, and both packages write the same JSON for the same
  graph-building calls.
- ``nd.save``: the same dict writes the same bytes in both packages, and
  each package's ``nd.load`` reads the other's file exactly.
- ``infer_shape``: the same argument and output shapes.
- ``eval_with``: outputs within 1e-5 of the JAX package's (float32; the
  two frameworks sum convolutions and matmuls in different orders).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch.symbol import load_json
from mxnet_tpu_torch.tools.profile_predict import (
    WAV2VEC2_LARGE_LV60, frames, wav2vec2_params, wav2vec2_symbol)

SMALL = dict(WAV2VEC2_LARGE_LV60, conv_dim=(32,) * 3, conv_kernel=(10, 3, 3),
             conv_stride=(5, 4, 4), hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
SAMPLES = 4000  # 0.25 s at 16 kHz
TOL = 1e-5


def _known(batch):
    """The data shape and the conv parameters' (the layer rules cannot
    derive a channel-last conv weight without a ``kernel=``)."""
    known = {"data": (batch, SAMPLES, 1)}
    c_in = 1
    for i, (c, k) in enumerate(zip(SMALL["conv_dim"], SMALL["conv_kernel"])):
        known[f"fe{i}_conv_weight"] = (c, k, c_in)
        known[f"fe{i}_conv_bias"] = (c,)
        c_in = c
    H, K = SMALL["hidden_size"], SMALL["num_conv_pos_embeddings"]
    G = SMALL["num_conv_pos_embedding_groups"]
    known["pos_conv_weight"] = (H, K, H // G)
    known["pos_conv_bias"] = (H,)
    return known


def test_json_round_trips_between_packages():
    jgraph = wav2vec2_symbol(jmx.sym, SMALL)
    text = jgraph.tojson()
    back = load_json(text)
    assert back.tojson() == text
    assert wav2vec2_symbol(sym, SMALL).tojson() == text
    assert back.list_arguments() == jgraph.list_arguments()
    # attribute values come back as the Python values the fusion pass
    # reads: strings, floats, ints, tuples, bools
    nodes = {s.name: s for s in back._walk()}
    assert nodes["fe0_gelu"]._kwargs == {"act_type": "gelu"}
    assert nodes["fe0_ln"]._kwargs == {"axis": -1, "eps": 1e-5}
    assert nodes["enc0_q_split"]._kwargs["shape"] == (0, 0, 4, 16)
    assert nodes["enc0_score"]._kwargs == {"transpose_b": True}
    assert nodes["enc0_scale"]._kwargs["scalar"] == 0.25
    assert nodes["pos_conv"]._kwargs["layout"] == "NWC"


def test_symbol_namespace_and_operators():
    x, y = sym.var("x"), sym.var("y")
    out = sym.Group([x + y, x * 2.0, sym.LeakyReLU(x, act_type="gelu")])
    assert out.list_arguments() == ["x", "y"]
    vals = out.eval_with({"x": nd.array([1.0, -2.0], ctx=mx.cpu()),
                          "y": nd.array([3.0, 4.0], ctx=mx.cpu())})
    assert [v.asnumpy().tolist() for v in vals[:2]] == [[4.0, 2.0],
                                                      [2.0, -4.0]]
    # a Variable's declared shape rides as an attribute, and a layer's
    # missing parameters become {node}_{input} variables
    fc = sym.FullyConnected(sym.var("d", shape=(2, 3)), num_hidden=5,
                            name="fc")
    assert fc.list_arguments() == ["d", "fc_weight", "fc_bias"]
    args, outs, _ = fc.infer_shape(d=(2, 3))
    assert args == [(2, 3), (5, 3), (5,)] and outs == [(2, 5)]


def _save_cases():
    rs = onp.random.RandomState(0)
    return {"arg:w": rs.randn(3, 4).astype("float32"),
            "aux:i": rs.randint(-5, 5, (2, 2)).astype("int32"),
            "u": rs.randint(0, 255, (2, 3)).astype("uint8"),
            "h": rs.randn(4).astype("float16"),
            "s": onp.array([2.5], dtype="float32")}


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def test_nd_save_same_bytes_and_cross_load(tmp_path):
    data = _save_cases()
    jpath, ppath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jmx.nd.save(jpath, {k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in data.items()})
    nd.save(ppath, {k: nd.array(v, ctx=mx.cpu(), dtype=v.dtype)
                    for k, v in data.items()})
    assert _same_bytes(jpath, ppath)
    for loaded in (nd.load(jpath, ctx=mx.cpu()), jmx.nd.load(ppath)):
        assert sorted(loaded) == sorted(data)
        for k, v in data.items():
            got = loaded[k].asnumpy()
            assert got.dtype == v.dtype and got.shape == v.shape
            onp.testing.assert_array_equal(got, v)


def test_nd_save_numpy_int64_and_lists(tmp_path):
    """Host arrays go in as they are (int64 included, which the JAX
    package's device arrays would narrow); a list saves without names."""
    data = dict(_save_cases(), l=onp.arange(-3, 4, dtype="int64") << 40)
    jpath, ppath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jmx.nd.save(jpath, data)
    nd.save(ppath, data)
    assert _same_bytes(jpath, ppath)
    onp.testing.assert_array_equal(nd.load(jpath, ctx=mx.cpu())["l"].asnumpy(),
                                   data["l"])
    nd.save(ppath, [data["arg:w"], data["aux:i"]])
    jmx.nd.save(jpath, [data["arg:w"], data["aux:i"]])
    assert _same_bytes(jpath, ppath)
    lst = jmx.nd.load(ppath)
    assert isinstance(lst, list) and len(lst) == 2
    onp.testing.assert_array_equal(lst[1].asnumpy(), data["aux:i"])


def test_nd_load_places_on_context(tmp_path):
    path = str(tmp_path / "p.params")
    nd.save(path, {"a": onp.ones((2, 2), "float32")})
    arr = nd.load(path, ctx=mx.cpu())["a"]
    assert arr.context == mx.cpu() and arr.data.device.type == "cpu"


def test_infer_shape_matches_jax():
    known = _known(2)
    want = wav2vec2_symbol(jmx.sym, SMALL).infer_shape(**known)
    got = wav2vec2_symbol(sym, SMALL).infer_shape(**known)
    assert got[0] == [tuple(s) for s in want[0]]
    assert got[1] == [tuple(s) for s in want[1]]
    T = frames(SMALL, SAMPLES)[-1]
    assert got[1] == [(2, T, SMALL["vocab_size"])]


def test_eval_with_matches_jax():
    params = wav2vec2_params(SMALL, 5)
    x = onp.random.RandomState(1).randn(2, SAMPLES, 1).astype("float32")
    jfeed = {k: jmx.nd.array(v) for k, v in params.items()}
    jfeed["data"] = jmx.nd.array(x)
    want = wav2vec2_symbol(jmx.sym, SMALL).eval_with(jfeed).asnumpy()
    pfeed = {k: nd.array(v, ctx=mx.cpu()) for k, v in params.items()}
    pfeed["data"] = nd.array(x, ctx=mx.cpu())
    with torch.no_grad():
        got = wav2vec2_symbol(sym, SMALL).eval_with(pfeed).asnumpy()
    assert got.shape == want.shape == (2, frames(SMALL, SAMPLES)[-1], 32)
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout,data,weight", [
    ("NWC", (2, 20, 6), (4, 3, 3)),
    ("NCW", (2, 6, 20), (4, 3, 3)),
    ("NHWC", (2, 9, 8, 6), (4, 3, 2, 3)),
    ("NCHW", (2, 6, 9, 8), (4, 3, 3, 2)),
])
def test_convolution_layouts_match_jax(layout, data, weight):
    """Grouped convolutions in both layouts, with stride, pad and bias:
    the channel-last weight is (O, *k, I/g), as in the JAX op."""
    rs = onp.random.RandomState(2)
    x = rs.randn(*data).astype("float32")
    w = rs.randn(*weight).astype("float32")
    b = rs.randn(4).astype("float32")
    kw = dict(stride=2, pad=1, num_filter=4, num_group=2, layout=layout)
    want = jmx.nd.convolution(jmx.nd.array(x), jmx.nd.array(w),
                              jmx.nd.array(b), **kw).asnumpy()
    got = nd.convolution(nd.array(x, ctx=mx.cpu()), nd.array(w, ctx=mx.cpu()),
                         nd.array(b, ctx=mx.cpu()), **kw).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op,kw", [
    ("activation", {"act_type": a})
    for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign")] + [
    ("leaky_relu", {"act_type": "leaky", "slope": 0.1}),
    ("leaky_relu", {"act_type": "elu", "slope": 0.7}),
    ("leaky_relu", {"act_type": "selu"}),
    ("leaky_relu", {"act_type": "gelu"}),
    ("leaky_relu", {"act_type": "rrelu"}),
    ("softmax", {"axis": 1, "temperature": 2.0}),
    ("layer_norm", {"axis": 1, "eps": 1e-3}),
])
def test_nn_ops_match_jax(op, kw):
    rs = onp.random.RandomState(3)
    x = (rs.randn(4, 6) * 3).astype("float32")
    args = [x]
    if op == "layer_norm":
        args += [rs.randn(6).astype("float32"), rs.randn(6).astype("float32")]
    want = getattr(jmx.nd, op)(*[jmx.nd.array(a) for a in args],
                               **kw).asnumpy()
    got = getattr(nd, op)(*[nd.array(a, ctx=mx.cpu()) for a in args],
                          **kw).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_layer_norm_output_mean_var_and_masked_softmax():
    rs = onp.random.RandomState(4)
    x = rs.randn(3, 5).astype("float32")
    g, b = rs.randn(5).astype("float32"), rs.randn(5).astype("float32")
    want = jmx.nd.layer_norm(jmx.nd.array(x), jmx.nd.array(g),
                             jmx.nd.array(b), output_mean_var=True)
    got = nd.layer_norm(*[nd.array(a, ctx=mx.cpu()) for a in (x, g, b)],
                        output_mean_var=True)
    for w, p in zip(want, got):
        onp.testing.assert_allclose(p.asnumpy(), w.asnumpy(), rtol=TOL,
                                    atol=TOL)
    length = onp.array([2, 5, 1], "int32")
    want = jmx.nd.softmax(jmx.nd.array(x), jmx.nd.array(length),
                          use_length=True).asnumpy()
    got = nd.softmax(nd.array(x, ctx=mx.cpu()), nd.array(length, ctx=mx.cpu()),
                     use_length=True).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,spec", [
    ((2, 3, 4), (0, -1)), ((2, 3, 4), (-3, 0)), ((6, 5, 4), (-4, 2, -1, -2)),
    ((2, 3, 4, 5), (0, 0, -3)), ((2, 3, 4), (-1,)),
])
def test_reshape_codes_match_jax(shape, spec):
    x = onp.arange(int(onp.prod(shape)), dtype="float32").reshape(shape)
    want = jmx.nd.reshape(jmx.nd.array(x), shape=spec).asnumpy()
    got = nd.reshape(nd.array(x, ctx=mx.cpu()), shape=spec).asnumpy()
    assert got.shape == want.shape
    onp.testing.assert_array_equal(got, want)


def test_eval_with_drops_dead_intermediates(monkeypatch):
    """``eval_with`` holds an op's value only until its last consumer
    has run: when ``square`` runs, ``exp``'s value (read by ``sqrt``
    alone) is gone, while ``x``'s second consumer keeps it; the outputs
    match the plain arithmetic."""
    import weakref

    from mxnet_tpu_torch.ndarray import registry

    seen = {}
    exp, square = registry.get_op("exp"), registry.get_op("square")

    def exp_spy(data):
        out = exp.fn(data)
        seen["exp"] = weakref.ref(out)
        return out

    def square_spy(data):
        seen["exp_alive_at_square"] = seen["exp"]() is not None
        return square.fn(data)

    for name, fn, base in (("exp", exp_spy, exp),
                           ("square", square_spy, square)):
        monkeypatch.setitem(registry._OPS, name, registry.OpDef(
            name, fn, base.differentiable, base.doc, base.namespaces))
    x = sym.var("x")
    out = sym.broadcast_add(sym.square(sym.sqrt(sym.exp(x))), x)
    data = onp.random.RandomState(0).rand(3, 4).astype("float32")
    got = out.eval_with({"x": nd.array(data, ctx=mx.cpu())}).asnumpy()
    assert seen["exp_alive_at_square"] is False
    onp.testing.assert_allclose(got, onp.exp(data) + data, rtol=1e-6)
