"""int8 post-training quantization in the PyTorch port against the JAX
package, on the CPU: the three quantize passes, ``quantize_model``,
``quantize_net``, ``quantize_net_graph`` and an int8 ResNet-18 served
through ``InferenceSession.predict``.

Both packages get the same float32 parameters and calibration batches
(numpy, from seeds). The rewritten graphs must list the same ops under
the same names in the same order, with the same kwargs; a calibrated
range is held to 1e-6 relative, because a naive range is the min or max
of a float32 convolution, whose summation order differs between XLA and
torch (one float32 ulp apart at most here). Entropy thresholds come from
histograms of the same samples (the JAX package's ``RandomState(0)``
draws) and are equal exactly. Offline int8 weights and every integer
output are equal exactly.

Run under ``MXNET_QUANTIZE_LOWERING`` ``native`` (the port's plain int8
versions, the JAX package's int8 XLA ops) and ``dequant`` (float32
contractions of the codes on both sides).
"""
import json

import numpy as onp
import pytest

from mxnet_tpu import autograd as jautograd
from mxnet_tpu import name as jname
from mxnet_tpu import nd as jnd
from mxnet_tpu import sym as JS
from mxnet_tpu.analysis import quantize as jqp
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, serving
from mxnet_tpu_torch import sym as TS
from mxnet_tpu_torch.analysis import graph_opt
from mxnet_tpu_torch.analysis import quantize as tqp
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.tools import profile_quant as pq

CPU = mx.cpu()
RANGE_RTOL = 1e-6
OUT_TOL = 1e-5


def _cnn(S):
    data = S.var("data")
    c1 = S.Convolution(data, name="conv1", kernel=(3, 3), num_filter=8,
                       pad=(1, 1))
    b1 = S.BatchNorm(c1, name="bn1", fix_gamma=False)
    a1 = S.Activation(b1, name="relu1", act_type="relu")
    c2 = S.Convolution(a1, name="conv2", kernel=(3, 3), num_filter=8,
                       pad=(1, 1))
    addn = S.elemwise_add(a1, c2, name="resadd")
    cat = S.Concat(addn, a1, name="cat1", dim=1)
    p1 = S.Pooling(cat, name="pool1", kernel=(2, 2), stride=(2, 2),
                   pool_type="max")
    f1 = S.Flatten(p1, name="flat1")
    return S.FullyConnected(f1, name="fc1", num_hidden=10)


def _mixed(S):
    data = S.var("data")
    c1 = S.Convolution(data, name="conv1", kernel=(3, 3), num_filter=6,
                       pad=(1, 1))
    sg = S.Activation(c1, name="sig1", act_type="sigmoid")
    c2 = S.Convolution(sg, name="conv2", kernel=(3, 3), num_filter=6,
                       pad=(1, 1))
    return S.FullyConnected(S.Flatten(c2, name="fl"), name="fc1",
                            num_hidden=4)


def _auto(S, with_pool):
    data = S.var("data")
    c1 = S.Convolution(data, name="conv1", kernel=(3, 3), num_filter=6,
                       pad=(1, 1))
    r1 = S.Activation(c1, name="relu1", act_type="relu")
    mid = S.Pooling(r1, name="pool1", kernel=(2, 2), stride=(2, 2),
                    pool_type="max") if with_pool else r1
    c2 = S.Convolution(mid, name="conv2", kernel=(3, 3), num_filter=6,
                       pad=(1, 1))
    return S.FullyConnected(S.Flatten(c2, name="fl"), name="fc1",
                            num_hidden=4)


def _params(js, data_shape, seed=0):
    """Float32 parameters (numpy) for ``js``: N(0, 0.2^2) weights, zero
    means, unit variances."""
    rs = onp.random.RandomState(seed)
    arg_shapes, _, aux_shapes = js.infer_shape(data=data_shape)
    args = {n: rs.randn(*s).astype("f") * 0.2
            for n, s in zip(js.list_arguments(), arg_shapes) if n != "data"}
    auxs = {n: (onp.zeros(s, "f") if "mean" in n else onp.ones(s, "f"))
            for n, s in zip(js.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _nodes(s):
    return [(n["op"], n["name"], n.get("attrs", {}))
            for n in json.loads(s.tojson())["nodes"]]


def _same_graph(tsym, jsym):
    """Same ops under the same names in the same order, the same kwargs
    (calibrated ranges and folded scale constants within RANGE_RTOL)."""
    tn, jn = _nodes(tsym), _nodes(jsym)
    assert [(o, n) for o, n, _ in tn] == [(o, n) for o, n, _ in jn]
    for (op, name, ta), (_, _, ja) in zip(tn, jn):
        assert sorted(ta) == sorted(ja), (name, ta, ja)
        for k in ta:
            if k in ("min_calib_range", "max_calib_range", "value"):
                onp.testing.assert_allclose(float(ta[k]), float(ja[k]),
                                            rtol=RANGE_RTOL, err_msg=name)
            else:
                assert ta[k] == ja[k], (name, k, ta[k], ja[k])


def _pair_params(args, auxs):
    return ({k: jnd.array(v) for k, v in args.items()},
            {k: jnd.array(v) for k, v in auxs.items()},
            {k: nd.array(v, ctx=CPU) for k, v in args.items()},
            {k: nd.array(v, ctx=CPU) for k, v in auxs.items()})


def _same_params(tq_, jq_):
    assert sorted(tq_) == sorted(jq_)
    for k, v in jq_.items():
        a, b = tq_[k].asnumpy(), v.asnumpy()
        assert a.dtype == b.dtype, k
        if a.dtype == onp.int8:
            onp.testing.assert_array_equal(a, b, err_msg=k)
        else:
            onp.testing.assert_allclose(a, b, rtol=RANGE_RTOL, err_msg=k)


def _rel(a, b):
    return float(onp.abs(a - b).max() / (onp.abs(b).max() + 1e-9))


@pytest.fixture(scope="module")
def cnn():
    js, ts = _cnn(JS), _cnn(TS)
    args, auxs = _params(js, (4, 3, 16, 16))
    x = onp.random.RandomState(7).randn(4, 3, 16, 16).astype("f")
    calib = [onp.random.RandomState(i).randn(4, 3, 16, 16).astype("f")
             for i in range(3)] + [x]
    return js, ts, args, auxs, x, calib


@pytest.fixture(autouse=True)
def _counters():
    tqp.reset_counters()
    jqp.reset_counters()
    yield


def _quantize_both(cnn, **kw):
    js, ts, args, auxs, x, calib = cnn
    ja, jx, ta, tx = _pair_params(args, auxs)
    jres = jq.quantize_model(js, ja, jx,
                             calib_data=[jnd.array(c) for c in calib], **kw)
    tres = tq.quantize_model(ts, ta, tx, calib_data=[
        nd.array(c, ctx=CPU) for c in calib], **kw)
    return jres, tres


def _eval_both(jres, tres, x):
    jo = jres[0].eval_with({**jres[1], **jres[2], "data": jnd.array(x)})
    to = tres[0].eval_with({**tres[1], **tres[2],
                            "data": nd.array(x, ctx=CPU)})
    return to.asnumpy(), jo.asnumpy()


@pytest.mark.parametrize("lowering", ["native", "dequant"])
@pytest.mark.parametrize("mode,kw", [
    ("naive", {}),
    ("entropy", {"excluded_sym_names": ("conv1", "bn1")}),
    ("naive", {"excluded_op_names": ("pooling", "elemwise_add")}),
    ("naive", {"quantized_dtype": "auto"}),
], ids=["naive", "entropy_excluded", "excluded_ops", "auto"])
def test_quantize_model_matches_jax(cnn, mode, kw, lowering, monkeypatch):
    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", lowering)
    jres, tres = _quantize_both(cnn, calib_mode=mode, **kw)
    _same_graph(tres[0], jres[0])
    _same_params(tres[1], jres[1])
    got, want = _eval_both(jres, tres, cnn[4])
    assert _rel(got, want) < OUT_TOL
    fp32 = cnn[1].eval_with({**{k: nd.array(v, ctx=CPU) for k, v in
                                {**cnn[2], **cnn[3]}.items()},
                             "data": nd.array(cnn[4], ctx=CPU)}).asnumpy()
    assert _rel(got, fp32) < 0.1
    assert tqp.counters() == jqp.counters()


def test_entropy_statistics_equal_jax(cnn):
    """``_collect_layer_statistics`` on the device path against the JAX
    host path: entropy thresholds exactly, naive ranges within 1e-6."""
    js, ts, args, auxs, x, calib = cnn
    ja, jx, ta, tx = _pair_params(args, auxs)
    # The JAX package runs the first call of an op signature in a process
    # op by op (its dispatch's uncached path) and every later call through
    # the jitted executable, whose fused BatchNorm rounds a float32 ulp
    # apart; whether an earlier test already made these calls decided
    # which of the two this test met. One warm-up pass makes it always
    # the jitted one, the program the port's results equal.
    jq._collect_layer_statistics(
        js, {**ja, **jx}, [jnd.array(c) for c in calib], ("data",), "naive")
    for mode in ("entropy", "naive"):
        jst = jq._collect_layer_statistics(
            js, {**ja, **jx}, [jnd.array(c) for c in calib], ("data",), mode)
        tst = tq._collect_layer_statistics(
            ts, {**ta, **tx}, [nd.array(c, ctx=CPU) for c in calib],
            ("data",), mode)
        assert sorted(tst) == sorted(jst)
        for k, (lo, hi) in jst.items():
            if mode == "entropy":
                assert tst[k] == (lo, hi), k
            else:
                onp.testing.assert_allclose(tst[k], (lo, hi),
                                            rtol=RANGE_RTOL, err_msg=k)


def test_calib_entropy_equals_jax():
    rs = onp.random.RandomState(3)
    for k in range(5):
        v = onp.abs(rs.randn(8192 * (1 + k % 3)) * rs.uniform(0.1, 5))
        if k % 4 == 0:
            v[: v.size // 3] = 0
        if k % 5 == 0:
            v = onp.abs(rs.standard_cauchy(v.size))
        h, e = onp.histogram(v.astype("f"), bins=2048 if k % 2 else 777)
        assert tq.calib_entropy(h, e) == jq.calib_entropy(h, e), k


def test_quantized_graph_is_one_region(cnn):
    qsym, offline = tq.quantize_symbol(cnn[1])
    jsym, joff = jq.quantize_symbol(cnn[0])
    assert offline == joff
    _same_graph(qsym, jsym)
    ops = [n[0] for n in _nodes(qsym)]
    assert ops.count("_contrib_quantize_v2") == 1
    assert ops.count("_contrib_dequantize") == 1
    assert tqp.counters()["islands_elided"] > 0


def test_mixed_boundaries_and_batch_dot():
    js, ts = _mixed(JS), _mixed(TS)
    args, _ = _params(js, (2, 3, 12, 12), seed=2)
    x = onp.random.RandomState(2).randn(2, 3, 12, 12).astype("f")
    calib = [x, onp.random.RandomState(5).randn(2, 3, 12, 12).astype("f")]
    ja, _, ta, _ = _pair_params(args, {})
    jres = jq.quantize_model(js, ja, {}, calib_mode="naive",
                             calib_data=[jnd.array(c) for c in calib])
    tres = tq.quantize_model(ts, ta, {}, calib_mode="naive",
                             calib_data=[nd.array(c, ctx=CPU) for c in calib])
    _same_graph(tres[0], jres[0])
    ops = [n[0] for n in _nodes(tres[0])]
    assert "Activation" in ops and ops.count("_contrib_quantize_v2") == 2
    got, want = _eval_both(jres, tres, x)
    assert _rel(got, want) < OUT_TOL
    for kw in ({}, {"transpose_b": True}):
        jo, to = JS.batch_dot(JS.var("a"), JS.var("b"), **kw), \
            TS.batch_dot(TS.var("a"), TS.var("b"), **kw)
        jsym, joff = jq.quantize_symbol(jo)
        tsym, toff = tq.quantize_symbol(to)
        assert toff == joff == {}
        _same_graph(tsym, jsym)
        rs = onp.random.RandomState(5)
        a = rs.randn(2, 4, 8).astype("f")
        b = rs.randn(2, 4, 8).astype("f") if kw else \
            rs.randn(2, 8, 4).astype("f")
        tout = tsym.eval_with({"a": nd.array(a, ctx=CPU),
                               "b": nd.array(b, ctx=CPU)}).asnumpy()
        jout = jsym.eval_with({"a": jnd.array(a),
                               "b": jnd.array(b)}).asnumpy()
        assert _rel(tout, jout) < OUT_TOL


@pytest.mark.parametrize("with_pool,uint8", [(False, 0), (True, 1)])
def test_auto_uint8_boundaries(with_pool, uint8):
    js, ts = _auto(JS, with_pool), _auto(TS, with_pool)
    args, _ = _params(js, (2, 3, 12, 12))
    x = onp.random.RandomState(0).randn(2, 3, 12, 12).astype("f")
    calib = [x, onp.random.RandomState(1).randn(2, 3, 12, 12).astype("f")]
    ja, _, ta, _ = _pair_params(args, {})
    kw = dict(calib_mode="naive", quantized_dtype="auto",
              excluded_sym_names=("conv1", "relu1"))
    jres = jq.quantize_model(js, ja, {},
                             calib_data=[jnd.array(c) for c in calib], **kw)
    tres = tq.quantize_model(ts, ta, {}, calib_data=[
        nd.array(c, ctx=CPU) for c in calib], **kw)
    _same_graph(tres[0], jres[0])
    u8 = [n for n in _nodes(tres[0]) if n[0] == "_contrib_quantize_v2"
          and n[2].get("out_type") == "uint8"]
    assert len(u8) == uint8
    got, want = _eval_both(jres, tres, x)
    assert _rel(got, want) < OUT_TOL


def test_elision_golden_and_its_negative():
    def golden(S, leak):
        x = S.var("x")
        q = S.quantize_v2(x, out_type="int8", name="q0")
        d = S.dequantize(q[0], q[1], q[2], name="d0")
        q2 = S.quantize_v2(d, out_type="int8", name="q1")
        out = S.dequantize(q2[0], q2[1], q2[2], name="d1")
        return S.Group([out, S.elemwise_add(q2[0], q2[0], name="leak")]) \
            if leak else out

    from mxnet_tpu.analysis.graph_opt import optimize_symbol as jopt

    for leak in (False, True):
        jo, _ = jopt(golden(JS, leak), level=1,
                     passes=("quantize_elide", "dce"), subject="elide")
        to, st = graph_opt.optimize_symbol(
            golden(TS, leak), level=1, passes=("quantize_elide", "dce"),
            subject="elide", device="cpu")
        assert not st["rejected"]
        assert [n[:2] for n in _nodes(to)] == [n[:2] for n in _nodes(jo)]
        assert tqp.counters()["islands_elided"] == \
            jqp.counters()["islands_elided"] == (0 if leak else 1)
        tqp.reset_counters()
        jqp.reset_counters()
    xs = onp.random.RandomState(3).randn(4, 5).astype("f")
    a = golden(TS, False).eval_with({"x": nd.array(xs, ctx=CPU)}).asnumpy()
    assert _rel(to.eval_with({"x": nd.array(xs, ctx=CPU)})[0].asnumpy(),
                a) < 0.02


def test_post_verify_rejects_a_broken_rewrite(cnn, monkeypatch):
    monkeypatch.setitem(tqp.QUANTIZED_OPS, "convolution",
                        "_contrib_quantized_bogus")
    qsym, offline = tq.quantize_symbol(cnn[1])
    assert offline == {} and qsym is cnn[1]
    assert graph_opt.counters()["graphs_rejected"] >= 1


def _jax_twin(tnet, jnet, x):
    """Copy ``tnet``'s float32 parameters into ``jnet`` (same structural
    names) and finish its shapes."""
    jp, tp = jnet._collect_params_with_prefix(), \
        tnet._collect_params_with_prefix()
    assert sorted(jp) == sorted(tp)
    for k, p in tp.items():
        jp[k]._load_init_from(jnd.array(p.data().asnumpy()))
    with jautograd.pause():
        jnet(jnd.array(x))
    return jnet


def _randomize_bn(net, seed):
    rs = onp.random.RandomState(seed)
    for name, p in net.collect_params().items():
        if name.endswith(("running_var", "gamma")):
            p.set_data(rs.uniform(0.5, 1.5, p.shape).astype("f"))
        elif name.endswith(("running_mean", "beta")):
            p.set_data(rs.uniform(-0.2, 0.2, p.shape).astype("f"))


@pytest.fixture(scope="module")
def resnet18():
    mx.random.seed(18)
    tnet = vision.resnet18_v1(classes=10, prefix="r18_")
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    x = onp.random.RandomState(1).randn(2, 3, 32, 32).astype("f") * 0.5
    with autograd.pause():
        tnet(nd.array(x, ctx=CPU))
    _randomize_bn(tnet, 18)
    jnet = _jax_twin(tnet, jvision.resnet18_v1(classes=10, prefix="r18_"), x)
    calib = [x, onp.random.RandomState(2).randn(2, 3, 32, 32)
             .astype("f") * 0.5]
    return tnet, jnet, x, calib


@pytest.fixture(scope="module")
def resnet18_int8(resnet18):
    # each package names the graph's unnamed nodes from its own
    # process-wide counters, which any earlier test in the process may
    # have moved: a fresh name scope each, so both start from 0
    tnet, jnet, x, calib = resnet18
    with mx.name.NameManager():
        tqb = tq.quantize_net_graph(tnet, calib_data=[
            nd.array(c, ctx=CPU) for c in calib], calib_mode="naive")
    with jname.NameManager():
        jqb = jq.quantize_net_graph(jnet, calib_data=[
            jnd.array(c) for c in calib], calib_mode="naive")
    return tqb, jqb


@pytest.mark.parametrize("lowering", ["native", "dequant"])
def test_resnet18_int8_served_matches_jax(resnet18, resnet18_int8, lowering,
                                          monkeypatch):
    """The slice end to end: ``quantize_net_graph`` in both packages,
    the port's block served by ``InferenceSession.predict``. The graphs
    are the same; the logits within 1e-5 of the largest JAX logit, and
    under ``native`` the last int32 accumulators equal."""
    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", lowering)
    tnet, jnet, x, calib = resnet18
    tqb, jqb = resnet18_int8
    _same_graph(tqb._outputs, jqb._outputs)
    assert pq.quantized_counts(tqb) == (20, 1)
    wq = [p for n, p in tqb.collect_params().items()
          if n.endswith("_quantized")]
    assert len(wq) == 21 and all(p.data().dtype == onp.int8 for p in wq)
    sess = serving.InferenceSession(tqb, input_shapes=[(1, 3, 32, 32)],
                                    buckets=[2], ctx=CPU)
    got = sess.predict(x).asnumpy()
    # the JAX logits and the classifier's int32 accumulators in one run
    heads = []
    for block, S, data in ((tqb, TS, nd.array(x, ctx=CPU)),
                           (jqb, JS, jnd.array(x))):
        fc = [s for s in block._outputs._walk()
              if s._op == "_contrib_quantized_fully_connected"][0]
        feed = {n: p.data() for n, p in block.collect_params().items()}
        feed["data"] = data
        heads.append([o.asnumpy() for o in S.Group(
            [fc[0], block._outputs]).eval_with(feed)])
    (acc, own), (jacc, want) = heads
    assert float(onp.abs(got - want).max()) <= \
        OUT_TOL * float(onp.abs(want).max())
    onp.testing.assert_array_equal(got, own)
    with autograd.pause():
        fp32 = tnet(nd.array(x, ctx=CPU)).asnumpy()
    assert pq.accuracy_delta(got, fp32) < 0.15
    assert acc.dtype == jacc.dtype == onp.int32
    if lowering == "native":  # the int32 lattice, bit for bit
        onp.testing.assert_array_equal(acc, jacc)


def test_jax_int8_graph_and_weights_carried_into_the_port(resnet18,
                                                        resnet18_int8,
                                                        monkeypatch):
    """The JAX package's quantized ResNet-18 (its graph as JSON, its
    parameters through ``convert.params_from_numpy``) runs in the port:
    the int8 weights and the float32 range variables keep their dtypes,
    and the int32 accumulators of the classifier equal the JAX ones."""
    from mxnet_tpu_torch import convert

    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", "native")
    _, _, x, _ = resnet18
    _, jqb = resnet18_int8
    tsym = TS.load_json(jqb._outputs.tojson())
    block = gluon.SymbolBlock(tsym, [TS.var("data")])
    jparams = {n: p.data().asnumpy()
               for n, p in jqb.collect_params().items()}
    convert.params_from_numpy(block, jparams, ctx=CPU)
    params = block.collect_params()
    for name, want in jparams.items():
        assert params[name].data().dtype == want.dtype, name
    assert {str(params[n].data().dtype) for n in jparams
            if n.endswith("_quantized")} == {"int8"}
    assert all(params[n].data().dtype == onp.float32 for n in jparams
               if n.endswith(("_min", "_max")))
    with autograd.pause():
        got = block(nd.array(x, ctx=CPU)).asnumpy()
    with jautograd.pause():
        want = jqb(jnd.array(x)).asnumpy()
    assert float(onp.abs(got - want).max()) <= \
        OUT_TOL * float(onp.abs(want).max())


def test_quantize_net_graph_exclusions_and_deferred_init():
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(4, 3, padding=1), tnn.Activation("relu"),
            tnn.Flatten(), tnn.Dense(5))
    net.initialize(mx.init.Xavier(), ctx=CPU)  # shapes deferred
    x = nd.array(onp.random.RandomState(0).randn(2, 3, 8, 8).astype("f"),
                 ctx=CPU)
    qb = tq.quantize_net_graph(net, calib_data=[x], calib_mode="naive",
                               exclude_layers_match=("conv",))
    js = qb._outputs.tojson()
    assert "_contrib_quantized_conv" not in js
    assert "_contrib_quantized_fully_connected" in js
    assert qb(x).shape == (2, 5)


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_block_swap_matches_jax(mode):
    """``quantize_net`` swaps Dense/Conv2D for the int8 wrappers; the
    same weights and calibration batches give the JAX package's output
    (its int8 wrappers always contract natively, the port's here under
    ``dequant``, exact at these sums)."""
    mx.random.seed(4)
    tnet = tnn.HybridSequential(prefix="qn_")
    tnet.add(tnn.Conv2D(6, 3, padding=1, activation="relu"),
             tnn.Conv2D(6, 3, strides=2, groups=2),
             tnn.Flatten(), tnn.Dense(5))
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    x = onp.random.RandomState(0).randn(3, 4, 10, 10).astype("f")
    with autograd.pause():
        fp32 = tnet(nd.array(x, ctx=CPU)).asnumpy()
    jnet = jnn.HybridSequential(prefix="qn_")
    jnet.add(jnn.Conv2D(6, 3, padding=1, activation="relu"),
             jnn.Conv2D(6, 3, strides=2, groups=2),
             jnn.Flatten(), jnn.Dense(5))
    jnet.initialize()
    jnet = _jax_twin(tnet, jnet, x)
    calib = [x, onp.random.RandomState(1).randn(3, 4, 10, 10).astype("f")]
    tq.quantize_net(tnet, calib_data=[nd.array(c, ctx=CPU) for c in calib],
                    calib_mode=mode)
    jq.quantize_net(jnet, calib_data=[jnd.array(c) for c in calib],
                    calib_mode=mode)
    with autograd.pause():
        got = tnet(nd.array(x, ctx=CPU)).asnumpy()
    with jautograd.pause():
        want = jnet(jnd.array(x)).asnumpy()
    assert _rel(got, want) < OUT_TOL
    if mode == "naive":  # entropy clips this small net's outliers hard
        assert _rel(got, fp32) < 0.1
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())


def test_captures_are_keyed_by_the_lowering(cnn, monkeypatch):
    """A hybridized quantized SymbolBlock keeps one CachedOp entry per
    resolved lowering (a capture bakes in the route); a float32 block's
    keys ignore the knob."""
    js, ts, args, auxs, x, calib = cnn
    _, _, ta, tx = _pair_params(args, auxs)
    qsym, qarg, qaux = tq.quantize_model(
        ts, ta, tx, calib_mode="naive",
        calib_data=[nd.array(c, ctx=CPU) for c in calib])
    qb = gluon.SymbolBlock(qsym, [TS.var("data")])
    params = qb.collect_params()
    for name, val in {**qarg, **qaux}.items():
        params[name].dtype = val.dtype
        if val.dtype == onp.int8:
            params[name].grad_req = "null"
        params[name]._load_init_from(val, ctx=CPU)
    qb.hybridize()
    fb = gluon.SymbolBlock(ts, [TS.var("data")])
    fparams = fb.collect_params()
    for name, val in {**ta, **tx}.items():
        fparams[name]._load_init_from(val, ctx=CPU)
    fb.hybridize()
    xs = nd.array(x, ctx=CPU)
    outs = {}
    for lw in ("native", "dequant", "native"):
        monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", lw)
        with autograd.pause():
            outs[lw] = qb(xs).asnumpy()
            fb(xs)
    assert len(qb._cached_op.entries) == 2
    assert len(fb._cached_op.entries) == 1
    salts = {k[-1] for k in qb._cached_op.entries}
    assert salts == {("quantize", "native"), ("quantize", "dequant")}
    onp.testing.assert_array_equal(outs["native"], outs["dequant"])


def test_resnet50_convolution_list_is_the_traced_graph():
    """``profile_quant.resnet50_convolutions`` (the shapes the card
    checks N2 at) lists the convolutions of the traced ``resnet50_v1``."""
    net = vision.resnet50_v1(classes=10)
    traced = net(TS.var("data"))
    convs = [s for s in traced._walk() if s._op == "convolution"]
    seen, nodes = set(), []
    for s in convs:
        if s._eval_key() not in seen:
            seen.add(s._eval_key())
            nodes.append(s)
    want = pq.resnet50_convolutions(2)
    assert len(nodes) == len(want) == 53
    shapes = {}
    from mxnet_tpu_torch.symbol.infer import infer_shapes

    _, _, node_shapes, _ = infer_shapes(traced, {"data": (2, 3, 224, 224)},
                                        return_node_shapes=True)
    for s in nodes:
        x_shape = node_shapes[id(s._inputs[0])]
        if isinstance(x_shape, list):
            x_shape = x_shape[s._inputs[0]._output_index]
        kw = s._kwargs
        k = tuple(kw["kernel"])
        shapes.setdefault((tuple(x_shape), (kw["num_filter"], x_shape[1])
                           + k, tuple(kw.get("stride") or (1, 1)),
                           tuple(kw.get("pad") or (0, 0))), 0)
    assert set(shapes) == {(x, w, tuple(st), tuple(p))
                           for x, w, st, p in want}
