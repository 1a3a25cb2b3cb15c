"""The bound executor: the port against the JAX package on the CPU.

``simple_bind``/``bind`` → ``forward``/``backward`` on the same graphs
with the same numpy-seeded arrays in both packages: outputs and
``grad_dict`` within 1e-5 for every loss head of the JAX executor's
``_LOSS_HEADS`` (its rule ignores ``grad_scale``), for head gradients
given to ``backward``, under ``grad_req="add"``, and batch norm's moving
statistics after a training forward. Also the bound arrays' dicts,
``copy_params_from``, ``reshape``, ``warmup``, the monitor's taps, the
two head-gradient rules side by side (the executor's against the ops'
own on the ``autograd`` path), and a training bind at
``MXNET_GRAPH_OPT=2``: the same gradients as at 0, with K3's cluster
replayed (never launched off torch's graph) and K1's keeping its
gradient.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, kernels, nd
from mxnet_tpu_torch.analysis import graph_opt

CPU = mx.cpu()
TOL = 1e-5


def _graph(S, head):
    data = S.Variable("data")
    net = S.FullyConnected(data, name="fc1", num_hidden=8,
                           weight=S.Variable("fc1_weight"),
                           bias=S.Variable("fc1_bias"))
    net = S.Activation(net, act_type="tanh", name="act")
    net = S.FullyConnected(net, name="fc2", num_hidden=4,
                           weight=S.Variable("fc2_weight"),
                           bias=S.Variable("fc2_bias"))
    label = S.Variable("label")
    if head == "softmax_output":
        return S.SoftmaxOutput(net, label, grad_scale=3.0, name="out")
    if head == "make_loss":
        return S.make_loss(S.sum(S.square(net)), grad_scale=5.0, name="out")
    if head == "group":
        return S.Group([S.SoftmaxOutput(net, label, name="sm"),
                        S.make_loss(S.sum(net), name="extra")])
    return getattr(S, head)(net, label, grad_scale=2.0, name="out")


def _feed(head, seed=0):
    rs = onp.random.RandomState(seed)
    feed = {"data": rs.randn(6, 5).astype("f"),
            "fc1_weight": (rs.randn(8, 5) * 0.4).astype("f"),
            "fc1_bias": (rs.randn(8) * 0.1).astype("f"),
            "fc2_weight": (rs.randn(4, 8) * 0.4).astype("f"),
            "fc2_bias": (rs.randn(4) * 0.1).astype("f")}
    if head in ("softmax_output", "group"):
        feed["label"] = onp.array([0, 3, 1, 2, 3, -1], "f")
    elif head == "logistic_regression_output":
        feed["label"] = (rs.rand(6, 4) > 0.5).astype("f")
    else:
        feed["label"] = rs.randn(6, 4).astype("f")
    return feed


def _bind(pkg, sym, feed, ctx, grad_req="write"):
    feed = {k: v for k, v in feed.items() if k in sym.list_arguments()}
    ex = sym.simple_bind(ctx=ctx, grad_req=grad_req,
                         **{k: v.shape for k, v in feed.items()})
    ex.copy_params_from({k: pkg.nd.array(v, ctx=ctx)
                         for k, v in feed.items()})
    return ex


def _both(head, grad_req="write"):
    return (_bind(jmx, _graph(jmx.sym, head), _feed(head), jmx.cpu(),
                  grad_req),
            _bind(mx, _graph(mx.sym, head), _feed(head), CPU, grad_req))


def _assert_grads(jex, tex, names=None):
    jg, tg = jex.grad_dict, tex.grad_dict
    for k in names or ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
        onp.testing.assert_allclose(tg[k].asnumpy(), jg[k].asnumpy(),
                                    rtol=TOL, atol=TOL)


@pytest.mark.parametrize("head", [
    "softmax_output", "make_loss", "linear_regression_output",
    "logistic_regression_output", "mae_regression_output", "group"])
def test_forward_and_loss_head_gradients_match_jax(head):
    jex, tex = _both(head)
    jo = jex.forward(is_train=True)
    to = tex.forward(is_train=True)
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        onp.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=TOL,
                                    atol=TOL)
    jex.backward()
    tex.backward()
    _assert_grads(jex, tex, names=["data", "fc1_weight", "fc1_bias",
                                   "fc2_weight", "fc2_bias"])
    assert tex.outputs is to and tex.output_shapes == \
        [tuple(s) for s in jex.output_shapes]


def test_executor_rule_ignores_grad_scale_the_autograd_rule_applies_it():
    """The two head-gradient rules of the JAX package: the executor's
    loss rule (unscaled: softmax - one_hot), the op's own VJP on the
    ``autograd`` path (a regression head scales by grad_scale / per-sample
    count)."""
    _, tex = _both("linear_regression_output")
    tex.forward(is_train=True)
    tex.backward()
    feed = _feed("linear_regression_output")
    args = {k: nd.array(v, ctx=CPU) for k, v in feed.items()}
    for k in ("fc2_bias",):
        args[k].attach_grad()
    with autograd.record():
        h = nd.tanh(nd.fully_connected(args["data"], args["fc1_weight"],
                                       args["fc1_bias"], num_hidden=8))
        o = nd.fully_connected(h, args["fc2_weight"], args["fc2_bias"],
                               num_hidden=4)
        out = nd.linear_regression_output(o, args["label"], grad_scale=2.0)
    out.backward()
    ex_g = tex.grad_dict["fc2_bias"].asnumpy()
    ag_g = args["fc2_bias"].grad.asnumpy()
    onp.testing.assert_allclose(ag_g, ex_g * 2.0 / 4, rtol=TOL, atol=TOL)


def test_head_gradients_given_to_backward_match_jax():
    jex, tex = _both("group")
    rs = onp.random.RandomState(3)
    cots = [rs.randn(6, 4).astype("f"), onp.ones((), "f").reshape(())]
    jex.forward(is_train=True)
    tex.forward(is_train=True)
    jex.backward([jmx.nd.array(c) for c in cots])
    tex.backward([nd.array(c, ctx=CPU) for c in cots])
    _assert_grads(jex, tex)


def test_grad_req_add_accumulates_like_jax():
    jex, tex = _both("make_loss", grad_req="add")
    for _ in range(2):
        for ex in (jex, tex):
            ex.forward(is_train=True)
            ex.backward()
    _assert_grads(jex, tex)
    single = _bind(mx, _graph(mx.sym, "make_loss"), _feed("make_loss"), CPU)
    single.forward(is_train=True)
    single.backward()
    onp.testing.assert_allclose(
        tex.grad_dict["fc1_weight"].asnumpy(),
        2 * single.grad_dict["fc1_weight"].asnumpy(), rtol=TOL, atol=TOL)


def test_batch_norm_moving_statistics_match_jax():
    def graph(S):
        x = S.Variable("data")
        y = S.BatchNorm(x, S.Variable("bn_gamma"), S.Variable("bn_beta"),
                        S.Variable("bn_moving_mean"),
                        S.Variable("bn_moving_var"), momentum=0.8,
                        fix_gamma=False, name="bn")
        return S.make_loss(S.sum(S.square(y)), name="loss")

    rs = onp.random.RandomState(4)
    x = (rs.randn(5, 3, 4, 4) * 2 + 1).astype("f")
    res = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, CPU)):
        s = graph(pkg.sym)
        assert s.list_auxiliary_states() == ["bn_moving_mean",
                                             "bn_moving_var"]
        ex = s.simple_bind(ctx=ctx, data=x.shape)
        ex.copy_params_from({"bn_gamma": pkg.nd.array(
            onp.full(3, 1.5, "f"), ctx=ctx)})
        for _ in range(2):
            ex.forward(is_train=True, data=pkg.nd.array(x, ctx=ctx))
        ex.backward()
        ex.forward(is_train=False)
        res.append({k: v.asnumpy() for k, v in ex.aux_dict.items()})
        res[-1]["out"] = ex.outputs[0].asnumpy()
        res[-1]["g"] = ex.grad_dict["bn_gamma"].asnumpy()
    for k in res[0]:
        onp.testing.assert_allclose(res[1][k], res[0][k], rtol=TOL,
                                    atol=TOL)
    assert not onp.allclose(res[1]["bn_moving_var"], 1.0)


def test_bound_arrays_copy_params_reshape_and_warmup():
    _, tex = _both("softmax_output")
    assert set(tex.arg_dict) == set(_feed("softmax_output"))
    assert set(tex.grad_dict) == set(tex.arg_dict)
    w = tex.arg_dict["fc1_weight"]
    ptr = w.data.data_ptr()
    tex.copy_params_from({"fc1_weight": nd.ones((8, 5), ctx=CPU)})
    assert w.data.data_ptr() == ptr and float(w.asnumpy().sum()) == 40
    with pytest.raises(ValueError, match="shape"):
        tex.copy_params_from({"fc1_weight": nd.ones((2, 2), ctx=CPU)})
    with pytest.raises(ValueError, match="not in the arguments"):
        tex.copy_params_from({"nope": nd.ones((2,), ctx=CPU)})
    tex.copy_params_from({"nope": nd.ones((2,), ctx=CPU)},
                         allow_extra_params=True)
    before = {k: v.asnumpy() for k, v in tex.grad_dict.items()}
    tex.warmup()
    for k, v in tex.grad_dict.items():
        onp.testing.assert_array_equal(v.asnumpy(), before[k])
    with pytest.raises(mx.MXNetError, match="unknown input"):
        tex.forward(bogus=nd.ones((1,), ctx=CPU))
    tex.reshape(data=(3, 5), label=(3,))
    assert tex.output_shapes == [(3, 4)]
    out = tex.forward(data=nd.ones((3, 5), ctx=CPU),
                      label=nd.zeros((3,), ctx=CPU))
    assert out[0].shape == (3, 4)
    assert mx.executor.executor_stats()["eager_forwards"] >= 1


def test_bind_over_the_callers_arrays_and_its_errors():
    s = _graph(mx.sym, "make_loss")
    feed = _feed("make_loss")
    names = s.list_arguments()
    args = [nd.array(feed[n], ctx=CPU) for n in names]
    grads = {n: nd.zeros(feed[n].shape, ctx=CPU) for n in names
             if n.endswith("weight")}
    ex = s.bind(CPU, args, args_grad=grads)
    ex.forward(is_train=True)
    ex.backward()
    assert set(ex.grad_dict) == set(grads)
    assert grads["fc1_weight"] is ex.grad_dict["fc1_weight"]
    assert float(onp.abs(grads["fc1_weight"].asnumpy()).sum()) > 0
    ref = _bind(mx, s, feed, CPU)
    ref.forward(is_train=True)
    ref.backward()
    onp.testing.assert_array_equal(grads["fc2_weight"].asnumpy(),
                                   ref.grad_dict["fc2_weight"].asnumpy())
    with pytest.raises(mx.MXNetError, match="slice"):
        s.simple_bind(ctx=[CPU, CPU], data=(6, 5), label=(6, 4))
    with pytest.raises(mx.MXNetError, match="cannot infer shape"):
        mx.sym.FullyConnected(mx.sym.Variable("x"), num_hidden=3,
                              name="f").simple_bind(ctx=CPU)
    with pytest.raises(mx.MXNetError, match="grad_req"):
        s.simple_bind(ctx=CPU, grad_req="sometimes", data=(6, 5))


def test_default_context_is_the_card():
    if mx.num_gpus():
        pytest.skip("checks the behaviour on a host without a CUDA device")
    with pytest.raises(mx.MXNetError, match="CUDA"):
        _graph(mx.sym, "make_loss").simple_bind(data=(6, 5), label=(6, 4))


def test_monitor_taps_every_op_output_by_name():
    seen = {}
    jseen = {}
    jex, tex = _both("softmax_output")
    tex.set_monitor_callback(lambda n, a: seen.setdefault(n, a.asnumpy()),
                             monitor_all=True)
    jex.set_monitor_callback(lambda n, a: jseen.setdefault(n, a.asnumpy()),
                             monitor_all=True)
    tex.forward(is_train=False)
    jex.forward(is_train=False)
    assert set(seen) == set(jseen)
    for k in jseen:
        onp.testing.assert_allclose(seen[k], jseen[k], rtol=TOL, atol=TOL)


def _attention_norm_graph(S):
    x = S.Variable("data")
    y = S.LayerNorm(x, S.Variable("ln_gamma"), S.Variable("ln_beta"),
                    name="ln")
    y = S.LeakyReLU(y, act_type="gelu", name="act")
    q = S.FullyConnected(y, num_hidden=16, flatten=False, name="q")
    s = S.softmax(S.batch_dot(q, q, transpose_b=True), axis=-1)
    return S.make_loss(S.sum(S.batch_dot(s, q)), name="loss")


def _attention_feed():
    rs = onp.random.RandomState(5)
    return {"data": rs.randn(2, 8, 16).astype("f"),
            "ln_gamma": (1 + 0.1 * rs.randn(16)).astype("f"),
            "ln_beta": (0.1 * rs.randn(16)).astype("f"),
            "q_weight": (0.2 * rs.randn(16, 16)).astype("f"),
            "q_bias": (0.1 * rs.randn(16)).astype("f")}


def _train_grads(sym, feed):
    ex = _bind(mx, sym, feed, CPU)
    ex.forward(is_train=True)
    ex.backward()
    return {k: v.asnumpy() for k, v in ex.grad_dict.items()}


def test_training_bind_at_graph_opt_2_keeps_every_gradient(monkeypatch):
    feed = _attention_feed()
    sym = _attention_norm_graph(mx.sym)
    monkeypatch.setenv("MXNET_GRAPH_OPT", "0")
    g0 = _train_grads(sym, feed)
    monkeypatch.setenv("MXNET_GRAPH_OPT", "2")
    graph_opt.reset_counters()
    g2 = _train_grads(sym, feed)
    assert graph_opt.counters().get("graphs_optimized", 0) >= 1
    for k in g0:
        onp.testing.assert_allclose(g2[k], g0[k], rtol=TOL, atol=TOL)


def test_graph_fused_for_the_card_replays_k3_and_keeps_k1_gradient(
        monkeypatch):
    """The graph as the fusion pass lowers it for a CUDA device (K3 and
    K1 chosen), bound for training: the K3 cluster replays its registered
    bodies (``replay_needs_grad``), K1's runs under its
    ``autograd.Function``, and every gradient equals the unfused graph's;
    an inference forward keeps ``impl="cuda"`` (on the CPU its plain
    version)."""
    monkeypatch.setenv("MXNET_GRAPH_OPT", "0")
    feed = _attention_feed()
    sym = _attention_norm_graph(mx.sym)
    fused, _ = graph_opt.optimize_symbol(
        sym, shapes={k: v.shape for k, v in feed.items()}, level=2,
        device="cuda")
    impls = {n._op: n._kwargs.get("impl") for n in fused._walk()
             if n._op and n._op.startswith("_fused")}
    assert impls == {"_fused_norm_act": "cuda", "_fused_attention": "cuda"}
    kernels.reset_counters()
    g_fused = _train_grads(fused, feed)
    assert kernels.counters().get("replay_needs_grad", 0) >= 1
    g_plain = _train_grads(sym, feed)
    for k in g_plain:
        onp.testing.assert_allclose(g_fused[k], g_plain[k], rtol=TOL,
                                    atol=TOL)
    kernels.reset_counters()
    ex = _bind(mx, fused, feed, CPU, grad_req="null")
    ex.forward(is_train=False)
    assert "replay_needs_grad" not in kernels.counters()


def test_verify_disposition(monkeypatch):
    s = _graph(mx.sym, "make_loss")
    monkeypatch.setenv("MXNET_GRAPH_VERIFY", "warn")
    ex = s.simple_bind(ctx=CPU, data=(6, 5))
    assert ex.outputs == []
    assert mx.analysis.verify_mode() == "warn"
    monkeypatch.setenv("MXNET_GRAPH_VERIFY", "error")
    assert mx.analysis.verify_mode() == "error"
    report = mx.analysis.DiagnosticReport(subject="bind:t")
    report.emit("GV403", "duplicate node name")
    with pytest.raises(mx.analysis.GraphVerifyError, match="bind:t"):
        report.disposition()
    monkeypatch.setenv("MXNET_GRAPH_VERIFY", "0")
    assert report.disposition() is report


def test_dropout_draws_a_fresh_mask_per_forward():
    """A reference-side caveat: the JAX executor traces the dropout key
    once, so its training forwards repeat one mask, and its backward
    raises (the key leaks out of the jitted forward). The port draws a
    fresh mask per forward and differentiates the forward's own."""
    import jax

    def graph(S):
        return S.make_loss(S.sum(S.Dropout(S.Variable("data"), p=0.5)
                                 * S.Variable("w")), name="l")

    jex = graph(jmx.sym).simple_bind(ctx=jmx.cpu(), data=(4, 8), w=(4, 8))
    jex.copy_params_from({"w": jmx.nd.ones((4, 8))})
    jl = [float(jex.forward(is_train=True, data=jmx.nd.ones((4, 8)))[0]
                .asnumpy()) for _ in range(3)]
    assert jl[0] == jl[1] == jl[2]
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jex.backward()
    tex = graph(mx.sym).simple_bind(ctx=CPU, data=(4, 8), w=(4, 8))
    tex.copy_params_from({"w": nd.ones((4, 8), ctx=CPU)})
    mx.random.seed(3)
    seen = []
    for _ in range(3):
        out = float(tex.forward(is_train=True,
                                data=nd.ones((4, 8), ctx=CPU))[0].asnumpy())
        tex.backward()
        g = tex.grad_dict["w"].asnumpy()
        # the gradient is the forward's own mask, scaled by 1 / (1 - p)
        assert set(onp.unique(g)) <= {0.0, 2.0}
        onp.testing.assert_allclose(g.sum(), out)
        seen.append(g)
    assert not onp.array_equal(seen[0], seen[1])
    assert float(tex.forward(is_train=False)[0].asnumpy()) == 32.0
