"""AMP in the PyTorch port against the JAX package (both on the CPU).

- Under ``amp.init("bfloat16")``, every op of the AMP lists that the
  port registers gives the JAX package's output dtype, exactly, for
  float32, bfloat16 and mixed inputs.
- The seven cases of ``tests/test_amp.py``, mirrored on the port: the
  cast policy, gradients through the casts, training with a loss
  scaler, the skipped overflow step, ``convert_model`` keeping norms in
  float32, the conditional fp32 ops, and ``convert_symbol``'s JSON
  nodes (compared with the JAX package's node for node).
- NDArray arithmetic and reductions follow the widest-type and fp32
  rules, as the JAX package's operators (which reach the registered
  ops) do.
"""
import json

import numpy as onp
import pytest

from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import amp as jamp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import lists
from mxnet_tpu_torch.gluon import fused_step, nn
from mxnet_tpu_torch.ndarray import registry

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    amp.disable()
    jamp.disable()
    fused_step.reset_fused_step_cache()


def _both(arr, dtype):
    """The same numpy array as a JAX-package and a port NDArray of
    ``dtype``."""
    j = jnd.array(arr)
    t = nd.array(arr, ctx=CPU)
    if dtype != "float32":
        j, t = j.astype(dtype), t.astype(dtype)
    return j, t


def _u(rs, *shape, lo=0.1, hi=0.9):
    return rs.uniform(lo, hi, shape).astype("float32")


# op -> (input arrays from a RandomState, kwargs); every array input is
# cast to the case's dtype (label-like inputs included, as blind casting
# leaves non-floats alone)
_CASES = {
    "convolution": (lambda rs: [_u(rs, 1, 2, 5, 5), _u(rs, 3, 2, 3, 3),
                                _u(rs, 3)],
                    {"kernel": (3, 3), "num_filter": 3}),
    "fully_connected": (lambda rs: [_u(rs, 2, 4), _u(rs, 3, 4), _u(rs, 3)],
                        {"num_hidden": 3}),
    "dot": (lambda rs: [_u(rs, 2, 3), _u(rs, 3, 4)], {}),
    "batch_dot": (lambda rs: [_u(rs, 2, 2, 3), _u(rs, 2, 3, 4)], {}),
    "batch_norm": (lambda rs: [_u(rs, 2, 3, 4, 4), _u(rs, 3), _u(rs, 3),
                               _u(rs, 3), _u(rs, 3)],
                   {"use_global_stats": True, "fix_gamma": False}),
    "layer_norm": (lambda rs: [_u(rs, 2, 4), _u(rs, 4), _u(rs, 4)], {}),
    "softmax": (lambda rs: [_u(rs, 2, 5)], {}),
    "log_softmax": (lambda rs: [_u(rs, 2, 5)], {}),
    "softmax_cross_entropy": (
        lambda rs: [_u(rs, 2, 5), onp.array([1.0, 3.0], "float32")], {}),
    "mean": (lambda rs: [_u(rs, 2, 5)], {}),
    "sum": (lambda rs: [_u(rs, 2, 5)], {}),
    "broadcast_power": (lambda rs: [_u(rs, 2, 3), _u(rs, 1, 3)], {}),
    "add_n": (lambda rs: [_u(rs, 2, 3), _u(rs, 2, 3), _u(rs, 2, 3)], {}),
}
# the slice of symbolic training: the fused RNN (a target op), the loss
# heads (fp32 ops) and the joins (widest-type ops)
_CASES["rnn"] = (lambda rs: [_u(rs, 3, 2, 4), _u(rs, 4 * 5 * (4 + 5 + 2)),
                             _u(rs, 1, 2, 5), _u(rs, 1, 2, 5)],
                 {"state_size": 5, "mode": "lstm"})
for _op in ("softmax_output", "linear_regression_output",
            "mae_regression_output", "logistic_regression_output"):
    _CASES[_op] = (lambda rs: [_u(rs, 2, 3), _u(rs, 2, 3)], {}) \
        if _op != "softmax_output" else \
        (lambda rs: [_u(rs, 2, 3), onp.array([0.0, 2.0], "float32")], {})
_CASES["make_loss"] = (lambda rs: [_u(rs, 2, 3)], {})
_CASES["concat"] = (lambda rs: [_u(rs, 2, 3), _u(rs, 2, 3)], {"dim": 0})
_CASES["stack"] = (lambda rs: [_u(rs, 2, 3), _u(rs, 2, 3)], {"axis": 1})
_CASES["where"] = (lambda rs: [_u(rs, 2, 3), _u(rs, 2, 3), _u(rs, 2, 3)],
                   {})
for _op in ("exp", "expm1", "log", "log10", "log1p", "log2", "erf",
            "erfinv", "gamma", "gammaln", "rsqrt", "rcbrt", "square",
            "reciprocal"):
    _CASES[_op] = (lambda rs: [_u(rs, 2, 3)], {})
for _op in ("broadcast_add", "broadcast_sub", "broadcast_mul",
            "broadcast_div", "broadcast_maximum", "broadcast_minimum",
            "broadcast_hypot", "broadcast_mod"):
    _CASES[_op] = (lambda rs: [_u(rs, 2, 3), _u(rs, 1, 3)], {})
for _op in ("elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
            "maximum", "minimum"):
    _CASES[_op] = (lambda rs: [_u(rs, 2, 3), _u(rs, 2, 3)], {})
# the AMP-listed ops of the NDArray and op surface (index arrays hold
# whole numbers, which every dtype represents exactly)
_CASES["_matmul"] = (lambda rs: [_u(rs, 2, 3), _u(rs, 3, 4)], {})
_CASES["batch_take"] = (lambda rs: [_u(rs, 3, 4),
                                    onp.array([1.0, 0.0, 3.0], "float32")],
                        {})
_CASES["take_along_axis"] = (
    lambda rs: [_u(rs, 3, 4), onp.array([[1.0], [3.0], [0.0]], "float32")],
    {"axis": 1})
_CASES["ctc_loss"] = (lambda rs: [_u(rs, 4, 2, 3),
                                  onp.array([[1.0, 2.0], [2.0, 0.0]],
                                            "float32")], {})
_CASES["deconvolution"] = (lambda rs: [_u(rs, 1, 2, 3, 3),
                                       _u(rs, 2, 3, 2, 2)],
                           {"kernel": (2, 2), "num_filter": 3})
_CASES["group_norm"] = (lambda rs: [_u(rs, 2, 4, 3), _u(rs, 2), _u(rs, 2)],
                        {"num_groups": 2})
_CASES["instance_norm"] = (lambda rs: [_u(rs, 2, 3, 4), _u(rs, 3),
                                       _u(rs, 3)], {})
_CASES["svm_output"] = (lambda rs: [_u(rs, 2, 3),
                                    onp.array([0.0, 2.0], "float32")], {})
for _op, _kw in (("l2_normalization", {}), ("lrn", {"nsize": 3}),
                 ("mean_all", {}), ("nanprod", {}), ("nansum", {}),
                 ("norm", {}), ("prod", {}), ("smooth_l1", {}),
                 ("softmin", {}), ("sum_axis", {"axis": 1})):
    _CASES[_op] = ((lambda rs: [_u(rs, 1, 3, 2, 2)]) if _op == "lrn" else
                   (lambda rs: [_u(rs, 2, 3)]), _kw)
for _op, _attr, _vals in lists.CONDITIONAL_FP32_OPS:
    for _v in _vals + (["relu"] if _op == "activation" else ["leaky"]):
        _CASES[f"{_op}:{_v}"] = (lambda rs: [_u(rs, 2, 3)], {_attr: _v})

_LISTED = set(lists.TARGET_DTYPE_OPS) | set(lists.FP32_OPS) | \
    set(lists.WIDEST_TYPE_CASTS) | {c[0] for c in lists.CONDITIONAL_FP32_OPS}


def test_every_registered_listed_op_has_a_case():
    registered = _LISTED & set(registry.list_ops())
    covered = {k.split(":")[0] for k in _CASES}
    assert registered <= covered, sorted(registered - covered)
    # the lists are the JAX package's, name for name
    from mxnet_tpu.contrib.amp import lists as jlists

    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "WIDEST_TYPE_CASTS",
                 "CONDITIONAL_FP32_OPS"):
        assert getattr(lists, name) == getattr(jlists, name)


@pytest.mark.parametrize("dtypes", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_amp_output_dtype_matches_jax(case, dtypes):
    op = case.split(":")[0]
    make, kwargs = _CASES[case]
    arrays = make(onp.random.RandomState(0))
    jargs, targs = [], []
    for i, a in enumerate(arrays):
        dt = dtypes if dtypes != "mixed" else \
            ("bfloat16" if i == 0 else "float32")
        j, t = _both(a, dt)
        jargs.append(j)
        targs.append(t)
    amp.init("bfloat16")
    jamp.init("bfloat16")
    jout = getattr(jnd, op)(*jargs, **kwargs)
    tout = getattr(nd, op)(*targs, **kwargs)
    jouts = jout if isinstance(jout, (list, tuple)) else [jout]
    touts = tout if isinstance(tout, (list, tuple)) else [tout]
    assert [str(o.dtype) for o in touts] == [str(o.dtype) for o in jouts]


@pytest.mark.parametrize("lhs,rhs", [("bfloat16", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "bfloat16")])
def test_ndarray_operators_follow_the_policy(lhs, rhs):
    """``a + b`` and friends reach the widest-type ops, ``x.sum()`` and
    ``x.mean()`` the fp32 ones, a Python scalar keeps the dtype: as the
    JAX package's operators do under AMP."""
    rs = onp.random.RandomState(1)
    ja, ta = _both(_u(rs, 2, 3), lhs)
    jb, tb = _both(_u(rs, 2, 3), rhs)
    amp.init("bfloat16")
    jamp.init("bfloat16")
    pairs = [(ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb),
             (ja / jb, ta / tb), (ja * 2.0, ta * 2.0), (3.0 - ja, 3.0 - ta),
             (ja.sum(), ta.sum()), (ja.mean(axis=1), ta.mean(axis=1))]
    for j, t in pairs:
        assert str(t.dtype) == str(j.dtype)


# -- tests/test_amp.py, mirrored --------------------------------------------

def test_amp_cast_policy():
    amp.init("bfloat16")
    x = nd.array(onp.random.rand(4, 8).astype("f"), ctx=CPU)
    w = nd.array(onp.random.rand(16, 8).astype("f"), ctx=CPU)
    out = nd.fully_connected(x, w, num_hidden=16, no_bias=True)
    assert str(out.dtype) == "bfloat16"  # target-dtype op
    s = nd.softmax(nd.array(onp.random.rand(2, 3).astype("f"), ctx=CPU)
                   .astype("bfloat16"))
    assert str(s.dtype) == "float32"  # fp32 op upcasts
    m = nd.elemwise_add(nd.array([1.], ctx=CPU).astype("bfloat16"),
                        nd.array([2.], ctx=CPU))
    assert str(m.dtype) == "float32"  # widest-type op
    amp.disable()
    out = nd.fully_connected(x, w, num_hidden=16, no_bias=True)
    assert str(out.dtype) == "float32"


def test_amp_grads_flow_through_casts():
    amp.init("bfloat16")
    x = nd.array(onp.random.rand(4, 8).astype("f"), ctx=CPU)
    w = nd.array(onp.random.rand(16, 8).astype("f"), ctx=CPU)
    w.attach_grad()
    with autograd.record():
        out = nd.fully_connected(x, w, num_hidden=16, no_bias=True)
        loss = nd.sum(out)
    loss.backward()
    g = w.grad
    assert str(g.dtype) == "float32"  # grads land in the param dtype
    assert float(nd.sum(nd.abs(g)).asnumpy()) > 0


def test_amp_training_with_loss_scaler():
    amp.init("bfloat16")
    mx.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(2))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    amp.init_trainer(tr)
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    rs = onp.random.RandomState(0)
    X = rs.randn(32, 8).astype("f")
    y = (X.sum(1) > 0).astype("f")
    first = None
    for _ in range(20):
        with autograd.record():
            l = lf(net(nd.array(X, ctx=CPU)), nd.array(y, ctx=CPU)).mean()
            with amp.scale_loss(l, tr) as sl:
                sl.backward()
        tr.step(1)
        first = first if first is not None else float(l.asscalar())
    assert float(l.asscalar()) < first * 0.8


def test_amp_overflow_skips_step():
    amp.init("bfloat16")
    net = nn.Dense(2)
    net.initialize(ctx=CPU)
    net(nd.ones((1, 3), ctx=CPU))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    amp.init_trainer(tr)
    p = list(net.collect_params().values())[0]
    with autograd.record():
        l = net(nd.ones((1, 3), ctx=CPU)).sum()
        l.backward()
    p.grad()[:] = float("inf")
    w0 = p.data().asnumpy().copy()
    s0 = tr._amp_loss_scaler.loss_scale
    tr.step(1)
    assert onp.allclose(p.data().asnumpy(), w0)
    assert tr._amp_loss_scaler.loss_scale == s0 / 2


def test_convert_model_keeps_norms_fp32():
    net = nn.HybridSequential()
    net.add(nn.Dense(4), nn.BatchNorm(), nn.Dense(2))
    net.initialize(ctx=CPU)
    net(nd.ones((2, 3), ctx=CPU))
    amp.convert_model(net, "bfloat16")
    params = net.collect_params()
    dtypes = {name: str(p.dtype) for name, p in params.items()}
    assert any(v == "bfloat16" for k, v in dtypes.items() if "dense" in k)
    assert all(v == "float32" for k, v in dtypes.items()
               if "batchnorm" in k or "gamma" in k or "beta" in k)
    # the tensors themselves, and the blocks' registered parameters
    for name, p in params.items():
        assert str(p.data().dtype) == dtypes[name]
    assert str(dict(net.named_parameters())["0.weight"].dtype) == \
        "torch.bfloat16"


def test_amp_conditional_fp32_ops():
    """CONDITIONAL_FP32_OPS (reference symbol.py:504): softrelu/elu/selu
    run fp32 under AMP; other attr values keep the target dtype."""
    amp.init("bfloat16")
    x = nd.array(onp.random.rand(4, 8).astype("f"), ctx=CPU) \
        .astype("bfloat16")
    assert nd.Activation(x, act_type="softrelu").dtype == onp.float32
    assert str(nd.Activation(x, act_type="relu").dtype) == "bfloat16"
    assert nd.LeakyReLU(x, act_type="elu").dtype == onp.float32
    assert nd.LeakyReLU(x, act_type="selu").dtype == onp.float32
    assert str(nd.LeakyReLU(x, act_type="leaky").dtype) == "bfloat16"


def _nodes(sym):
    return [(n["op"], n.get("attrs", {})) for n in
            json.loads(sym.tojson())["nodes"]]


def test_amp_convert_symbol_conditional():
    import mxnet_tpu.symbol as JS
    import mxnet_tpu_torch.symbol as S

    a = S.Variable("data")
    net = S.Activation(S.FullyConnected(a, name="fc", num_hidden=4),
                       name="sr", act_type="softrelu")
    cs = amp.convert_symbol(net, target_dtype="bfloat16")
    nodes = json.loads(cs.tojson())["nodes"]
    f32_casts = [n for n in nodes if n["op"] == "amp_cast"
                 and "float32" in str(n.get("attrs", {}))]
    assert f32_casts, "softrelu input not cast to fp32"
    # node for node as the JAX package converts the same graph
    ja = JS.Variable("data")
    jnet = JS.Activation(JS.FullyConnected(ja, name="fc", num_hidden=4),
                         name="sr", act_type="softrelu")
    assert _nodes(cs) == _nodes(jamp.convert_symbol(jnet))


def test_convert_symbol_widest_round_trip_and_eval():
    """A widest-type op routes its inputs through one amp_multicast; the
    graph writes to JSON, loads back and evaluates to the JAX graph's
    values and dtypes."""
    import mxnet_tpu.symbol as JS
    import mxnet_tpu_torch.symbol as S

    cs = amp.convert_symbol(S.elemwise_add(S.Variable("a"), S.Variable("b"),
                                           name="add"))
    jcs = jamp.convert_symbol(JS.elemwise_add(JS.Variable("a"),
                                              JS.Variable("b"), name="add"))
    assert _nodes(cs) == _nodes(jcs)
    rs = onp.random.RandomState(3)
    av, bv = _u(rs, 2, 3), _u(rs, 2, 3)
    ja, ta = _both(av, "bfloat16")
    jb, tb = _both(bv, "float32")
    got = S.load_json(cs.tojson()).eval_with({"a": ta, "b": tb})
    want = jcs.eval_with({"a": ja, "b": jb}) if hasattr(jcs, "eval_with") \
        else None
    assert str(got.dtype) == "float32"
    if want is not None:
        want = want[0] if isinstance(want, (list, tuple)) else want
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=1e-6)
    from mxnet_tpu_torch.symbol import infer

    _, out_types = infer.infer_types(cs, {"a": ta.dtype, "b": "float32"})
    assert [str(d) for d in out_types] == ["float32"]
    _, out_shapes = infer.infer_shapes(cs, {"a": (2, 3), "b": (2, 3)},
                                       dtypes={"a": "bfloat16",
                                               "b": "float32"})
    assert out_shapes == [(2, 3)]


def test_amp_init_rejects_other_dtypes_and_bumps_the_version():
    v0 = registry.amp_version()
    with pytest.raises(ValueError):
        amp.init("float64")
    amp.init("bfloat16")
    assert registry.amp_version() == v0 + 1
    amp.disable()
    assert registry.amp_version() == v0 + 2


def test_bf16_arrays_cross_bit_for_bit():
    """``ml_dtypes`` bfloat16 arrays (the JAX package's) land in the port
    bit for bit and come back the same way."""
    import ml_dtypes

    rs = onp.random.RandomState(4)
    a = rs.randn(5, 3).astype(ml_dtypes.bfloat16)
    t = nd.array(a, ctx=CPU)
    assert str(t.dtype) == "bfloat16"
    back = t.asnumpy()
    assert back.dtype == a.dtype
    assert back.view(onp.int16).tobytes() == a.view(onp.int16).tobytes()
    j = jnd.array(a)
    assert onp.asarray(j.asnumpy()).view(onp.int16).tobytes() == \
        back.view(onp.int16).tobytes()


def test_half_products_sum_in_float32_by_the_ports_scope(monkeypatch):
    """bf16 products run in the port's cuBLAS scope: the reduced-precision
    split-K reductions off inside, torch's flags restored after; float32
    products get a no-op scope."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ndarray import ops_nn

    m = torch.backends.cuda.matmul
    before = (m.allow_bf16_reduced_precision_reduction,
              m.allow_fp16_reduced_precision_reduction)
    seen = []
    real = F.linear

    def spy(*args):
        seen.append((args[0].dtype, m.allow_bf16_reduced_precision_reduction,
                     m.allow_fp16_reduced_precision_reduction))
        return real(*args)

    monkeypatch.setattr(ops_nn.F, "linear", spy)
    x = nd.array(onp.ones((2, 4), "f"), ctx=CPU)
    w = nd.array(onp.ones((3, 4), "f"), ctx=CPU)
    nd.fully_connected(x.astype("bfloat16"), w.astype("bfloat16"),
                       num_hidden=3, no_bias=True)
    nd.fully_connected(x, w, num_hidden=3, no_bias=True)
    assert seen[0] == (torch.bfloat16, False, False)
    assert seen[1] == (torch.float32,) + before
    assert (m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction) == before
    assert ops_nn.cublas_fp32_accumulate(torch.float32) is \
        ops_nn.cublas_fp32_accumulate(torch.float64)
