"""The graph optimizer and the fusion pass: the port against the JAX
package.

Each graph of ``tests/test_fusion.py`` is built over both packages'
``sym`` and optimized by both ``optimize_symbol`` at
``MXNET_GRAPH_OPT=2``, on the CPU (the port with ``device="cpu"``, the
JAX package on its CPU backend). The optimized graphs must hold the same
ops, and the fusion and graph-opt counters must agree (the JAX
package's ``impl_lax`` is the port's ``impl_torch``; pass times are not
compared). The port's optimized graph must equal its unfused graph bit
for bit: the fused ops replay the member ops' bodies.

Knobs: the kill switch ``MXNET_FUSION=0``, ``MXNET_FUSION_PATTERNS``,
``MXNET_FUSION_COST_MODEL=never``; and post-verify rejection, where a
fused op that cannot run makes both optimizers serve the original graph.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import kernels as jkernels
from mxnet_tpu.analysis import graph_opt as jgraph_opt
from mxnet_tpu.ndarray import registry as jregistry

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels, nd, sym
from mxnet_tpu_torch.analysis import graph_opt
from mxnet_tpu_torch.analysis.graph_opt import _Graph, optimize_symbol
from mxnet_tpu_torch.kernels import cost_model
from mxnet_tpu_torch.ndarray import registry


@pytest.fixture(autouse=True)
def _armed(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPH_OPT", "2")
    for knob in ("MXNET_FUSION", "MXNET_FUSION_PATTERNS",
                 "MXNET_FUSION_COST_MODEL"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (kernels, jkernels, graph_opt, jgraph_opt):
        mod.reset_counters()
    yield
    for mod in (kernels, jkernels, graph_opt, jgraph_opt):
        mod.reset_counters()


def _chain(s):
    x = s.var("x")
    return s.sqrt(s.broadcast_add(s.exp(x), s.square(x)))


def _norm_act(s):
    d, g, b = s.var("data"), s.var("gamma"), s.var("beta")
    return s.leaky_relu(s.layer_norm(d, g, b), act_type="gelu")


def _attention(scale_op):
    def build(s):
        q, k, v = s.var("q"), s.var("k"), s.var("v")
        sc = s.batch_dot(q, k, transpose_b=True)
        if scale_op == "mul":
            sc = s.broadcast_mul_scalar(sc, scalar=0.125)
        elif scale_op == "div":
            sc = s.broadcast_div_scalar(sc, scalar=8.0)
        return s.batch_dot(s.softmax(sc), v)
    return build


def _multi_consumer(s):
    x = s.var("x")
    e = s.exp(x)
    return s.sqrt(e) + e


def _bn_act(s):
    out = s.batch_norm(s.var("data"), s.var("gamma"), s.var("beta"),
                       s.var("moving_mean"), s.var("moving_var"))
    return s.activation(out, act_type="relu")


def _ops(g):
    return sorted(n._op for n in _Graph(g).nodes if n._op is not None)


def _jops(g):
    return sorted(n._op for n in jgraph_opt._Graph(g).nodes
                  if n._op is not None)


def _counters():
    """Both packages' fusion and graph-opt counters, named alike."""
    def norm(d):
        return {k.replace("impl_lax", "impl_torch"): v for k, v in d.items()
                if not k.endswith("_time_ms") and v}
    return (norm(jkernels.counters()), norm(kernels.counters()),
            norm(jgraph_opt.counters()), norm(graph_opt.counters()))


def _feed(shapes, seed=7):
    rs = onp.random.RandomState(seed)
    return {k: rs.randn(*v).astype("float32") for k, v in shapes.items()}


def _eval(g, feed):
    return g.eval_with({k: nd.array(v, ctx=mx.cpu())
                        for k, v in feed.items()}).asnumpy()


def _both(build, shapes):
    """Optimize the graph in both packages; returns the port's original
    and optimized graphs after checking ops and counters agree."""
    jopt, jst = jgraph_opt.optimize_symbol(build(jmx.sym), shapes=shapes,
                                           subject="t")
    out = build(sym)
    opt, st = optimize_symbol(out, shapes=shapes, subject="t", device="cpu")
    assert _ops(opt) == _jops(jopt)
    assert st["rejected"] == jst["rejected"]
    assert st["rewrites"] == jst["rewrites"]
    jk, pk, jg, pg = _counters()
    assert pk == jk
    assert pg == jg
    return out, opt


GRAPHS = {
    "chain": (_chain, {"x": (4, 5)}, ["_fused_elementwise"]),
    "norm_act": (_norm_act, {"data": (8, 16), "gamma": (16,),
                             "beta": (16,)}, ["_fused_norm_act"]),
    "attention_mul": (_attention("mul"), {k: (2, 6, 8) for k in "qkv"},
                      ["_fused_attention"]),
    "attention_div": (_attention("div"), {k: (2, 6, 8) for k in "qkv"},
                      ["_fused_attention"]),
    "attention_none": (_attention("none"), {k: (2, 6, 8) for k in "qkv"},
                       ["_fused_attention"]),
    "attention_compute_bound": (
        _attention("mul"), {k: (2, 64, 8) for k in "qkv"},
        ["batch_dot", "batch_dot", "broadcast_mul_scalar", "softmax"]),
    "multi_consumer": (_multi_consumer, {"x": (4, 4)},
                       ["_fused_elementwise", "exp"]),
    "bn_act": (_bn_act, {"data": (4, 3), "gamma": (3,), "beta": (3,),
                         "moving_mean": (3,), "moving_var": (3,)},
               ["activation", "batch_norm"]),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_same_rewrite_as_jax_and_bitwise_replay(name):
    build, shapes, want_ops = GRAPHS[name]
    out, opt = _both(build, shapes)
    assert _ops(opt) == want_ops
    feed = _feed(shapes)
    if name == "bn_act":  # variances must be positive
        feed["moving_var"] = onp.abs(feed["moving_var"]) + 0.5
    assert (_eval(out, feed) == _eval(opt, feed)).all()


def test_reject_reasons_are_counted():
    _both(*GRAPHS["attention_compute_bound"][:2])
    assert kernels.counters()["fallback_compute_bound_attention"] == 1
    _both(*GRAPHS["bn_act"][:2])
    assert kernels.counters()["fallback_effectful"] >= 1


def test_kill_switch(monkeypatch):
    monkeypatch.setenv("MXNET_FUSION", "0")
    _, opt = _both(_chain, {"x": (4, 5)})
    assert "_fused_elementwise" not in _ops(opt)
    assert kernels.counters()["pass_skipped_disabled"] >= 1
    assert kernels.fusion_salt() == ("fusion", 0)


def test_patterns_knob_selects_subset(monkeypatch):
    monkeypatch.setenv("MXNET_FUSION_PATTERNS", "norm_act,bogus")
    assert kernels.enabled_patterns() == ("norm_act",)
    _, ew = _both(_chain, {"x": (4, 5)})
    assert "_fused_elementwise" not in _ops(ew)
    _, na = _both(*GRAPHS["norm_act"][:2])
    assert "_fused_norm_act" in _ops(na)


def test_cost_model_never(monkeypatch):
    monkeypatch.setenv("MXNET_FUSION_COST_MODEL", "never")
    _, opt = _both(_chain, {"x": (4, 5)})
    assert "_fused_elementwise" not in _ops(opt)
    assert kernels.counters()["fallback_cost_model_never"] >= 1


def test_post_verify_rejection_serves_original(monkeypatch):
    def bad(*data, program=()):
        """A fused body that cannot run (test double)."""
        raise ValueError("broken fused kernel")

    for reg in (registry, jregistry):
        good = reg.get_op("_fused_elementwise")
        monkeypatch.setitem(reg._OPS, "_fused_elementwise", reg.OpDef(
            "_fused_elementwise", bad, good.differentiable, bad.__doc__,
            good.namespaces))
    out = _chain(sym)
    jopt, jst = jgraph_opt.optimize_symbol(_chain(jmx.sym),
                                           shapes={"x": (4, 5)})
    opt, st = optimize_symbol(out, shapes={"x": (4, 5)}, device="cpu")
    assert st["rejected"] is jst["rejected"] is True
    assert opt is out
    jk, pk, jg, pg = _counters()
    assert pk == jk and pk["fallback_post_verify"] == 1
    assert pg == jg and pg["graphs_rejected"] == 1


def test_fusion_salt_tracks_knobs(monkeypatch):
    armed = graph_opt.fingerprint_salt()
    assert armed[-1] == kernels.fusion_salt() == jkernels.fusion_salt()
    monkeypatch.setenv("MXNET_FUSION_PATTERNS", "elementwise")
    assert kernels.fusion_salt() != armed[-1]


@pytest.mark.parametrize("pattern,shape,dtype,axis,want", [
    ("norm_act", (8, 512), "float32", -1, ("cuda", "ok")),
    ("norm_act", (8, 512), "bfloat16", 1, ("cuda", "ok")),
    ("norm_act", (8, 9000), "float32", -1, ("torch", "norm_width")),
    ("norm_act", (8, 512), "float32", 0, ("torch", "norm_axis")),
    ("norm_act", (8, 512), "float64", -1, ("torch", "kernel_dtype")),
    ("norm_act", None, None, -1, ("torch", "shape_unknown")),
    ("attention", (128, 499, 64), "float32", -1, ("cuda", "ok")),
    ("attention", (4, 6, 300), "float32", -1, ("torch", "attention_shape")),
    ("elementwise", (4, 5), "float32", -1, ("torch", "ok")),
])
def test_cost_model_viability_rule(pattern, shape, dtype, axis, want):
    """``cuda`` when the graph runs on a CUDA device and the kernel takes
    the cluster, the torch replay (with the reason) otherwise; on the
    CPU always the replay."""
    import torch

    dt = getattr(torch, dtype) if dtype else None
    d = cost_model.decide(pattern, 3, out_shape=shape, device="cuda",
                          dtype=dt, norm_axis=axis)
    assert d.fuse and (d.impl, d.reason) == want
    d = cost_model.decide(pattern, 3, out_shape=shape, device="cpu",
                          dtype=dt, norm_axis=axis)
    assert d.fuse and (d.impl, d.reason) == ("torch", "ok")


def test_cost_model_goldens_match_jax():
    from mxnet_tpu.kernels import cost_model as jcost

    cases = [("elementwise", 1, None, None), ("elementwise", 3, None, None),
             ("elementwise", 3, (1 << 23,), None),
             ("attention", 3, None, (2, 64, 64)),
             ("attention", 3, None, (2, 63, 64)),
             ("attention", 3, None, (2, 6, 6)), ("norm_act", 2, (8, 16), None)]
    for pattern, n, out_shape, score in cases:
        j = jcost.decide(pattern, n, out_shape=out_shape, score_shape=score)
        p = cost_model.decide(pattern, n, out_shape=out_shape,
                              score_shape=score, device="cpu")
        assert (p.fuse, p.reason) == (j.fuse, j.reason)
    for mode in ("never", "always"):
        j = jcost.decide("attention", 1, mode=mode)
        p = cost_model.decide("attention", 1, mode=mode)
        assert (p.fuse, p.reason) == (j.fuse, j.reason)


def test_optimized_for_cuda_on_a_host_without_one():
    """Optimizing for the card needs no card: shape inference runs the op
    bodies on meta tensors, and the kernels' wrappers return empty
    results there, so post-verify accepts the fused graph."""
    shapes = {"data": (8, 16), "gamma": (16,), "beta": (16,)}
    opt, st = optimize_symbol(_norm_act(sym), shapes=shapes, device="cuda")
    assert not st["rejected"] and _ops(opt) == ["_fused_norm_act"]
    assert opt._kwargs["impl"] == "cuda"
    shapes = {k: (2, 70, 8) for k in "qkv"}
    opt, st = optimize_symbol(_attention("mul")(sym), shapes=shapes,
                              device="cuda")
    assert not st["rejected"] and _ops(opt) == ["_fused_attention"]
    assert opt._kwargs["impl"] == "cuda"
    # and run on CPU tensors, the CUDA impls take the plain versions
    feed = _feed(shapes)
    want = _eval(_attention("mul")(sym), feed)
    onp.testing.assert_allclose(_eval(opt, feed), want, rtol=1e-5,
                                atol=1e-5)


def test_fold_cse_and_elision_match_jax():
    def build(s):
        x = s.var("x")
        c = s.broadcast_add(s.ones((2, 3)), s.ones((2, 3)))  # folds
        y = s.transpose(s.transpose(x, axes=(1, 0)), axes=(1, 0))  # cancels
        a, b = s.exp(y), s.exp(y)  # one of them goes (cse)
        return s.broadcast_add(s.broadcast_mul(a, c), b)

    out, opt = _both(build, {"x": (2, 3)})
    feed = _feed({"x": (2, 3)})
    assert (_eval(out, feed) == _eval(opt, feed)).all()
    c = graph_opt.counters()
    assert c["fold_rewrites"] >= 1 and c["cse_rewrites"] >= 1
    assert c["transpose_elision_rewrites"] >= 1


def _attention_dv(s):
    """Attention whose values are wider than its queries and keys."""
    q, k, v = s.var("q"), s.var("k"), s.var("v")
    return s.batch_dot(s.softmax(s.batch_dot(q, k, transpose_b=True)), v)


def _attention_transposed_k(s):
    """Attention whose keys are a transposed (permuted-view) input."""
    q, kt, v = s.var("q"), s.var("kt"), s.var("v")
    k = s.transpose(kt, axes=(0, 2, 1))
    sc = s.broadcast_mul_scalar(s.batch_dot(q, k, transpose_b=True),
                                scalar=0.125)
    return s.batch_dot(s.softmax(sc), v)


@pytest.mark.parametrize("name,build,shapes,want", [
    ("values_wider", _attention_dv,
     {"q": (2, 6, 8), "k": (2, 6, 8), "v": (2, 6, 16)},
     ("torch", "attention_operands")),
    ("keys_transposed", _attention_transposed_k,
     {"q": (2, 70, 8), "kt": (2, 8, 70), "v": (2, 70, 8)}, ("cuda", None)),
])
def test_cuda_attention_operands(name, build, shapes, want):
    """On a CUDA device K1 takes an attention cluster only when v has k's
    shape: values of another width stay the replay (below the
    compute-bound length, which would leave them unfused), with the
    reason counted. A permuted-view k is taken (the op copies it contiguous),
    and the fused graph still computes the unfused one's values."""
    opt, st = optimize_symbol(build(sym), shapes=shapes, device="cuda")
    assert not st["rejected"]
    fused = [n for n in _Graph(opt).nodes if n._op == "_fused_attention"]
    assert len(fused) == 1 and fused[0]._kwargs["impl"] == want[0]
    c = kernels.counters()
    if want[1]:
        assert c[f"replay_{want[1]}"] == 1
    else:
        assert not any(k.startswith("replay_") and v for k, v in c.items())
    feed = _feed(shapes)
    onp.testing.assert_allclose(_eval(opt, feed), _eval(build(sym), feed),
                                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pattern,shapes,dtypes,want", [
    ("attention", [(4, 9, 8), (4, 9, 8), (4, 9, 8)], ["float32"] * 3, "ok"),
    ("attention", [(4, 9, 8), (4, 9, 8), (4, 9, 8)],
     ["float32", "bfloat16", "float32"], "operand_dtype"),
    ("attention", [(4, 9, 8), (4, 9, 8), (4, 9, 16)], ["float32"] * 3,
     "attention_operands"),
    ("attention", [(4, 9, 8), (2, 9, 8), (2, 9, 8)], ["float32"] * 3,
     "attention_operands"),
    ("attention", [(4, 9, 8), None, (4, 9, 8)], ["float32"] * 3,
     "shape_unknown"),
    ("norm_act", [(8, 512), (512,), (512,)],
     ["float32", "bfloat16", "float32"], "operand_dtype"),
])
def test_cost_model_operand_rule(pattern, shapes, dtypes, want):
    import torch

    ops = [(s, getattr(torch, d)) for s, d in zip(shapes, dtypes)]
    out = (4, 9, 8) if pattern == "attention" else (8, 512)
    d = cost_model.decide(pattern, 3, out_shape=out, device="cuda",
                          dtype=torch.float32, operands=ops)
    assert d.fuse and d.reason == want
    assert d.impl == ("cuda" if want == "ok" else "torch")


def _meta_broken_sqrt(monkeypatch):
    """``sqrt`` that runs on real tensors but fails on meta tensors, as an
    op whose shape inference broke (test double)."""
    good = registry.get_op("sqrt")

    def sqrt(data):
        if data.device.type == "meta":
            raise RuntimeError("no meta kernel")
        return good.fn(data)

    monkeypatch.setitem(registry._OPS, "sqrt", registry.OpDef(
        "sqrt", sqrt, good.differentiable, good.doc, good.namespaces))


def test_cuda_unknown_shape_raises(monkeypatch):
    """A graph optimized for a CUDA device whose cluster shape inference
    cannot resolve raises instead of serving the replay; the same graph
    for the CPU is fused as the replay."""
    _meta_broken_sqrt(monkeypatch)

    def build(s):
        d, g, b = s.var("data"), s.var("gamma"), s.var("beta")
        return s.leaky_relu(s.layer_norm(s.sqrt(d), g, b), act_type="gelu")

    shapes = {"data": (8, 16), "gamma": (16,), "beta": (16,)}
    with pytest.raises(mx.MXNetError, match="unknown shape"):
        optimize_symbol(build(sym), shapes=shapes, device="cuda")
    opt, _ = optimize_symbol(build(sym), shapes=shapes, device="cpu")
    fused = [n for n in _Graph(opt).nodes if n._op == "_fused_norm_act"]
    assert len(fused) == 1 and fused[0]._kwargs["impl"] == "torch"


def test_cuda_post_verify_rejection_raises(monkeypatch):
    """A fused graph for a CUDA device that fails verification raises: on
    the card the original graph would be served with the kernels unused."""
    def bad(*data, program=()):
        """A fused body that cannot run (test double)."""
        raise ValueError("broken fused kernel")

    good = registry.get_op("_fused_elementwise")
    monkeypatch.setitem(registry._OPS, "_fused_elementwise", registry.OpDef(
        "_fused_elementwise", bad, good.differentiable, bad.__doc__,
        good.namespaces))
    with pytest.raises(mx.MXNetError, match="fails verification"):
        optimize_symbol(_chain(sym), shapes={"x": (4, 5)}, device="cuda")
