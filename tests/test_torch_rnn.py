"""The fused ``rnn`` op, the recurrent ops around it, and the legacy and
Gluon RNN cells and layers: the port against the JAX package on the CPU.

Inputs come from numpy seeds and weights are copied across, never
redrawn. Tolerances: the ``rnn`` op within 1e-5 in float32, forward and
gradients (torch's fused RNN and the JAX ``lax.scan`` sum the same gate
products in different orders), also against the op's own plain version;
the cells and layers within 1e-5; the shape and index ops exactly.
"""
import random

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.ndarray import ops_nn
from mxnet_tpu_torch.ndarray.ops_nn import (rnn_param_size, rnn_param_views,
                                            rnn_plain)

CPU = mx.cpu()
TOL = 1e-5
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


def _pair(a):
    return jnd.array(a), nd.array(a, ctx=CPU)


def _rnn_inputs(mode, layers, bi, T=5, B=3, I=4, H=6, seed=0):
    rs = onp.random.RandomState(seed)
    D = 2 if bi else 1
    n = rnn_param_size(layers, I, H, bi, mode)
    return dict(
        x=rs.randn(T, B, I).astype("f"),
        w=(rs.randn(n) * 0.3).astype("f"),
        h=rs.randn(layers * D, B, H).astype("f"),
        c=rs.randn(layers * D, B, H).astype("f"),
        cots=[rs.randn(T, B, D * H).astype("f"),
              rs.randn(layers * D, B, H).astype("f"),
              rs.randn(layers * D, B, H).astype("f")],
        kw=dict(state_size=H, num_layers=layers, mode=mode,
                bidirectional=bi))


def _run(ndmod, ag, inp, mode, extra=None):
    """Outputs and the gradients of sum(out * cot) for x, w, h (and c for
    an LSTM) through ``ndmod.rnn``."""
    names = ["x", "w", "h"] + (["c"] if mode == "lstm" else [])
    if ndmod is nd:
        arrs = [nd.array(inp[k], ctx=CPU) for k in names]
    else:
        arrs = [jnd.array(inp[k]) for k in names]
    for a in arrs:
        a.attach_grad()
    kw = dict(inp["kw"], **(extra or {}))
    with ag.record():
        outs = ndmod.rnn(arrs[0], arrs[1], arrs[2],
                         arrs[3] if mode == "lstm" else None, **kw)
        cots = inp["cots"][:len(outs)]
        loss = sum((o * ndmod.array(c) if ndmod is jnd else
                    o * nd.array(c, ctx=CPU)).sum()
                   for o, c in zip(outs, cots))
    loss.backward()
    return ([o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrs])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("bi", [False, True])
def test_rnn_op_matches_jax(mode, layers, bi):
    inp = _rnn_inputs(mode, layers, bi)
    jo, jg = _run(jnd, jag, inp, mode)
    to, tg = _run(nd, autograd, inp, mode)
    assert len(jo) == len(to) == (3 if mode == "lstm" else 2)
    for a, b in zip(jo + jg, to + tg):
        onp.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bi", [False, True])
def test_rnn_op_against_its_plain_version(mode, bi):
    inp = _rnn_inputs(mode, 2, bi, seed=3)
    t = {k: torch.tensor(inp[k], requires_grad=True)
         for k in ("x", "w", "h", "c")}
    res = []
    for fn in (ops_nn.rnn, rnn_plain):
        ins = [t["x"], t["w"], t["h"], t["c"] if mode == "lstm" else None]
        outs = fn(*ins, **inp["kw"])
        targets = [v for k, v in t.items() if mode == "lstm" or k != "c"]
        cots = [torch.tensor(c) for c in inp["cots"][:len(outs)]]
        grads = torch.autograd.grad(outs, targets, cots)
        res.append([o.detach().numpy() for o in outs] +
                   [g.numpy() for g in grads])
    for a, b in zip(*res):
        onp.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_rnn_views_follow_the_packed_layout():
    """Per layer and direction W_i then W_h, then every bias; gradients
    through the views land in the vector."""
    L, I, H = 2, 3, 4
    n = rnn_param_size(L, I, H, True, "gru")
    w = torch.arange(n, dtype=torch.float32)
    views = rnn_param_views(w, "gru", L, I, H, True)
    assert [tuple(v.shape) for v in views[0]] == [(12, 3), (12, 4), (12,),
                                                  (12,)]
    assert [tuple(v.shape) for v in views[2]] == [(12, 8), (12, 4), (12,),
                                                  (12,)]
    assert views[0][0].flatten()[0] == 0
    assert views[0][1].flatten()[0] == 36
    weights = sum(v[0].numel() + v[1].numel() for v in views)
    assert views[0][2][0] == weights
    assert views[-1][3][-1] == n - 1
    with pytest.raises(mx.MXNetError, match="parameter vector"):
        rnn_param_views(w[:-1], "gru", L, I, H, True)


def test_rnn_clip_and_ignored_arguments_match_jax():
    """The cell-state clip (the plain step loop); ``projection_size`` and
    ``sequence_length`` are accepted and ignored, as the JAX op does."""
    inp = _rnn_inputs("lstm", 2, False, seed=5)
    clip = dict(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.3)
    jo, jg = _run(jnd, jag, inp, "lstm", clip)
    to, tg = _run(nd, autograd, inp, "lstm", clip)
    for a, b in zip(jo + jg, to + tg):
        onp.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    plain, _ = _run(nd, autograd, inp, "lstm")
    assert not onp.allclose(plain[2], to[2])
    assert onp.abs(to[2]).max() <= 0.3 + 1e-7
    ign, _ = _run(nd, autograd, inp, "lstm", dict(
        projection_size=3, use_sequence_length=True,
        sequence_length=nd.array([1, 2, 3], ctx=CPU)))
    for a, b in zip(plain, ign):
        onp.testing.assert_array_equal(a, b)


def test_rnn_dropout_draws_from_mx_random():
    """Between layers, in training only, from the device generator: a
    reseeded run repeats its masks, and outside training the op equals
    p = 0."""
    inp = _rnn_inputs("lstm", 3, False, seed=7)
    args = [nd.array(inp[k], ctx=CPU) for k in ("x", "w", "h", "c")]

    def run(p, train, seed=1):
        mx.random.seed(seed)
        with autograd.record(train_mode=train):
            return nd.rnn(*args, p=p, **inp["kw"])[0].asnumpy()

    base = run(0.0, True)
    onp.testing.assert_array_equal(run(0.5, False), base)
    a, b = run(0.5, True), run(0.5, True)
    onp.testing.assert_array_equal(a, b)
    assert not onp.allclose(a, base)
    assert not onp.allclose(a, run(0.5, True, seed=2))
    # one layer has no layer after it: no dropout
    one = _rnn_inputs("gru", 1, False)
    a1 = [nd.array(one[k], ctx=CPU) for k in ("x", "w", "h")]
    with autograd.record():
        onp.testing.assert_array_equal(
            nd.rnn(*a1, None, p=0.9, **one["kw"])[0].asnumpy(),
            nd.rnn(*a1, None, **one["kw"])[0].asnumpy())


def test_rnn_without_state_outputs_and_symbol_shapes():
    inp = _rnn_inputs("gru", 2, True)
    out = nd.rnn(*[nd.array(inp[k], ctx=CPU) for k in ("x", "w", "h")],
                 None, state_outputs=False, **inp["kw"])
    assert isinstance(out, nd.NDArray) and out.shape == (5, 3, 12)
    s = mx.sym.RNN(mx.sym.Variable("data"), mx.sym.Variable("p"),
                   mx.sym.Variable("s"), state_size=6, num_layers=2,
                   mode="lstm", name="r")
    j = jmx.sym.RNN(jmx.sym.Variable("data"), jmx.sym.Variable("p"),
                    jmx.sym.Variable("s"), state_size=6, num_layers=2,
                    mode="lstm", name="r")
    assert s.list_outputs() == j.list_outputs() == \
        ["r_output0", "r_output1", "r_output2"]
    args, outs, _ = s.infer_shape(data=(5, 3, 4))
    jargs, jouts, _ = j.infer_shape(data=(5, 3, 4))
    assert args == [tuple(a) for a in jargs]
    assert outs == [tuple(o) for o in jouts]
    assert args == [(5, 3, 4), (rnn_param_size(2, 4, 6, False, "lstm"),),
                    (2, 3, 6)]
    assert [s[i].infer_shape(data=(5, 3, 4))[1][0] for i in range(3)] == \
        [(5, 3, 6), (2, 3, 6), (2, 3, 6)]


# -- the ops around the RNN ---------------------------------------------------


def _both(fn_name, arrays, kwargs, grad=True):
    """``fn_name`` through both packages' ``nd`` with the first array
    recorded; outputs and its gradient of sum(out * r)."""
    res = []
    for ndm, ag in ((jnd, jag), (nd, autograd)):
        arrs = [ndm.array(a) if ndm is jnd else nd.array(a, ctx=CPU)
                for a in arrays]
        arrs[0].attach_grad()
        with ag.record():
            out = getattr(ndm, fn_name)(*arrs, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            if grad:
                rs = onp.random.RandomState(9)
                loss = sum((o * (ndm.array(rs.randn(*o.shape).astype("f"))
                                 if ndm is jnd else nd.array(
                                     rs.randn(*o.shape).astype("f"),
                                     ctx=CPU))).sum() for o in outs)
        if grad:
            loss.backward()
        res.append(([o.asnumpy() for o in outs],
                    arrs[0].grad.asnumpy() if grad else None))
    return res


_SEQ_DATA = onp.random.RandomState(2).randn(5, 3, 2).astype("f")
_LENS = onp.array([2, 5, 1], "f")


@pytest.mark.parametrize("op,arrays,kwargs", [
    ("sequence_mask", [_SEQ_DATA, _LENS],
     dict(use_sequence_length=True, value=-1.0)),
    ("sequence_mask", [_SEQ_DATA.transpose(1, 0, 2).copy(), _LENS],
     dict(use_sequence_length=True, axis=1)),
    ("sequence_mask", [_SEQ_DATA], {}),
    ("sequence_last", [_SEQ_DATA, _LENS], dict(use_sequence_length=True)),
    ("sequence_last", [_SEQ_DATA], {}),
    ("sequence_reverse", [_SEQ_DATA, _LENS], dict(use_sequence_length=True)),
    ("sequence_reverse", [_SEQ_DATA], {}),
    ("slice_channel", [_SEQ_DATA], dict(num_outputs=3, axis=1)),
    ("slice_channel", [_SEQ_DATA], dict(num_outputs=5, axis=0,
                                        squeeze_axis=True)),
    ("split", [_SEQ_DATA], dict(num_outputs=2, axis=-1)),
    ("split_v2", [_SEQ_DATA], dict(indices_or_sections=(1, 3), axis=0)),
    ("split_v2", [_SEQ_DATA], dict(indices_or_sections=3, axis=1,
                                   squeeze_axis=True)),
    ("concat", [_SEQ_DATA, _SEQ_DATA * 2], dict(dim=1)),
    ("stack", [_SEQ_DATA, _SEQ_DATA * 2], dict(axis=2)),
    ("swapaxes", [_SEQ_DATA], dict(dim1=0, dim2=2)),
    ("squeeze", [_SEQ_DATA[:1]], dict(axis=0)),
    ("where", [(_SEQ_DATA > 0).astype("f"), _SEQ_DATA, -_SEQ_DATA], {}),
    ("softmax_output", [_SEQ_DATA.reshape(15, 2), _LENS[:1].repeat(15)], {}),
    ("softmax_output", [_SEQ_DATA, onp.zeros((5, 2), "f")],
     dict(multi_output=True)),
    ("make_loss", [_SEQ_DATA], dict(grad_scale=3.0)),
    ("stop_gradient", [_SEQ_DATA], {}),
    ("BlockGrad", [_SEQ_DATA], {}),
    ("linear_regression_output", [_SEQ_DATA, _SEQ_DATA[::-1].copy()],
     dict(grad_scale=2.0)),
    ("mae_regression_output", [_SEQ_DATA, _SEQ_DATA[::-1].copy()], {}),
    ("logistic_regression_output", [_SEQ_DATA, (_SEQ_DATA > 0).astype("f")],
     dict(grad_scale=0.5)),
])
def test_ops_match_jax(op, arrays, kwargs):
    """Forward, and the gradient of the first input on the ``nd`` /
    ``autograd`` path: the regression heads' own rule (the head gradient
    ignored, scaled by grad_scale / per-sample count), softmax_output's
    softmax VJP, zero through stop_gradient."""
    (jo, jg), (to, tg) = _both(op, arrays, kwargs,
                               grad=op not in ("where",))
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        onp.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    if jg is not None:
        onp.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


# -- the legacy symbolic cells ------------------------------------------------


def _bind_eval(pkg, out, feed, ctx):
    names = out.list_arguments()
    ex = out.simple_bind(ctx=ctx, grad_req="null",
                         **{k: v.shape for k, v in feed.items()})
    ex.copy_params_from({k: pkg.nd.array(v, ctx=ctx) for k, v in feed.items()
                         if k in names}, allow_extra_params=True)
    return [o.asnumpy() for o in ex.forward(is_train=False)]


def _legacy(pkg, kind):
    r = pkg.rnn
    if kind == "seq":
        c = r.SequentialRNNCell()
        c.add(r.LSTMCell(6, prefix="l0_"))
        c.add(r.DropoutCell(0.0, prefix="d_"))
        c.add(r.GRUCell(6, prefix="l1_"))
        return c
    if kind == "bi":
        return r.BidirectionalCell(r.LSTMCell(6, prefix="l_"),
                                   r.RNNCell(6, prefix="r_"))
    if kind == "fused":
        return r.FusedRNNCell(6, num_layers=2, mode="gru", prefix="f_")
    return {"rnn": lambda: r.RNNCell(6, activation="relu", prefix="c_"),
            "lstm": lambda: r.LSTMCell(6, prefix="c_"),
            "gru": lambda: r.GRUCell(6, prefix="c_")}[kind]()


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "seq", "bi",
                                  "fused"])
def test_legacy_cells_unroll_like_jax(kind):
    T, B, I = 4, 3, 5
    outs = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, CPU)):
        cell = _legacy(pkg, kind)
        data = pkg.sym.Variable("data")
        # a fused cell unrolls as its unfused stack: one state per layer
        info = cell.unfuse().state_info if kind == "fused" else \
            cell.state_info
        o, states = cell.unroll(T, data, layout="NTC", merge_outputs=True,
                                begin_state=[pkg.sym.zeros((B, 6))
                                             for _ in info])
        outs.append((pkg.sym.Group([o] + list(states)), cell))
    jsym, tsym = outs[0][0], outs[1][0]
    assert tsym.list_arguments() == jsym.list_arguments()
    j_shapes = dict(zip(jsym.list_arguments(),
                        jsym.infer_shape(data=(B, T, I))[0]))
    rs = onp.random.RandomState(1)
    feed = {k: (rs.randn(*s) * 0.3).astype("f") for k, s in j_shapes.items()}
    a = _bind_eval(jmx, jsym, feed, jmx.cpu())
    b = _bind_eval(mx, tsym, feed, CPU)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        onp.testing.assert_allclose(y, x, rtol=TOL, atol=TOL)
    assert [i["shape"] for i in outs[1][1].state_info] == \
        [i["shape"] for i in outs[0][1].state_info]


def test_legacy_lstm_bias_hint_and_row_shapes():
    j, t = jmx.rnn.LSTMCell(4, forget_bias=2.0), mx.rnn.LSTMCell(
        4, forget_bias=2.0)
    onp.testing.assert_array_equal(t.bias_init_value(), j.bias_init_value())
    assert t.state_row_shapes() == j.state_row_shapes() == [(4,), (4,)]
    with pytest.raises(NotImplementedError):
        mx.rnn.BidirectionalCell(t, t)(None, [])


# -- the Gluon cells and layers -----------------------------------------------


def _copy_params(jblock, tblock):
    jp = {k: v.data().asnumpy() for k, v in jblock.collect_params().items()}
    for k, v in tblock.collect_params().items():
        v.set_data(nd.array(jp[k], ctx=CPU))


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "RNN"])
@pytest.mark.parametrize("bi", [False, True])
def test_gluon_layers_match_jax(cls, bi):
    """The fused layers forward and backward, with and without states,
    eager and hybridized."""
    D = 2 if bi else 1
    kw = dict(num_layers=2, bidirectional=bi, input_size=5, prefix="l_")
    jl = getattr(jmx.gluon.rnn, cls)(8, **kw)
    jl.initialize(jmx.init.Xavier())
    x = onp.random.RandomState(0).randn(4, 3, 5).astype("f")
    nst = 2 if cls == "LSTM" else 1
    st = [onp.random.RandomState(i).randn(2 * D, 3, 8).astype("f") * 0.5
          for i in range(nst)]
    jx = jnd.array(x)
    jx.attach_grad()
    with jag.record():
        jo, js = jl(jx, [jnd.array(s) for s in st])
        jloss = jo.sum() + sum(s.sum() for s in js)
    jloss.backward()
    for hyb in (False, True):
        tl = getattr(mx.gluon.rnn, cls)(8, **kw)
        tl.initialize(ctx=CPU)
        _copy_params(jl, tl)
        if hyb:
            tl.hybridize()
        tx = nd.array(x, ctx=CPU)
        tx.attach_grad()
        with autograd.record():
            to, ts = tl(tx, [nd.array(s, ctx=CPU) for s in st])
            tloss = to.sum() + sum(s.sum() for s in ts)
        tloss.backward()
        onp.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=TOL,
                                    atol=TOL)
        for a, b in zip(js, ts):
            onp.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=TOL,
                                        atol=TOL)
        onp.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                                    rtol=TOL, atol=TOL)
        jw = jl.collect_params()["l_l0_i2h_weight"]
        tw = tl.collect_params()["l_l0_i2h_weight"]
        onp.testing.assert_allclose(tw.grad().asnumpy(),
                                    jw.grad().asnumpy(), rtol=TOL, atol=TOL)
        # no states: the zero states, one output
        out = tl(nd.array(x, ctx=CPU))
        onp.testing.assert_allclose(out.asnumpy(),
                                    jl(jnd.array(x)).asnumpy(), rtol=TOL,
                                    atol=TOL)
    stats = mx.gluon.cached_op_stats()
    assert stats["calls"] >= 2


def test_gluon_layer_ntc_layout_and_deferred_input():
    jl = jmx.gluon.rnn.GRU(4, layout="NTC", prefix="g_")
    jl.initialize(jmx.init.Xavier())
    x = onp.random.RandomState(3).randn(2, 5, 3).astype("f")
    jo = jl(jnd.array(x))
    tl = mx.gluon.rnn.GRU(4, layout="NTC", prefix="g_")
    tl.initialize(ctx=CPU)
    tl(nd.array(x, ctx=CPU))  # finishes the deferred input width
    _copy_params(jl, tl)
    onp.testing.assert_allclose(tl(nd.array(x, ctx=CPU)).asnumpy(),
                                jo.asnumpy(), rtol=TOL, atol=TOL)


def _gcell(pkg, kind):
    r = pkg.gluon.rnn
    if kind == "seq":
        c = r.SequentialRNNCell(prefix="s_")
        with c.name_scope():
            c.add(r.LSTMCell(6, input_size=5))
            c.add(r.DropoutCell(0.0))
            c.add(r.ResidualCell(r.GRUCell(6, input_size=6)))
        return c
    if kind == "bi":
        return r.BidirectionalCell(r.LSTMCell(6, input_size=5, prefix="l_"),
                                   r.GRUCell(6, input_size=5, prefix="r_"))
    if kind == "zoneout":
        return r.ZoneoutCell(r.RNNCell(6, input_size=5, prefix="z_"))
    return {"rnn": lambda: r.RNNCell(6, input_size=5, prefix="c_"),
            "lstm": lambda: r.LSTMCell(6, input_size=5, prefix="c_"),
            "gru": lambda: r.GRUCell(6, input_size=5, prefix="c_")}[kind]()


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "seq", "bi",
                                  "zoneout"])
def test_gluon_cells_unroll_like_jax(kind):
    x = onp.random.RandomState(4).randn(3, 4, 5).astype("f")
    jc = _gcell(jmx, kind)
    jc.initialize(jmx.init.Xavier())
    # the JAX package's unroll passes the batch size positionally, which
    # a sequential or modifier cell's begin_state does not take: give it
    # the zero states (the port's unroll makes them itself)
    jbegin = [jnd.zeros(i["shape"]) for i in jc.state_info(3)]
    if kind in ("seq", "zoneout"):
        with pytest.raises(TypeError):
            jc.unroll(4, jnd.array(x), layout="NTC", merge_outputs=True)
    jo, js = jc.unroll(4, jnd.array(x), layout="NTC", merge_outputs=True,
                       begin_state=jbegin)
    tc = _gcell(mx, kind)
    tc.initialize(ctx=CPU)
    _copy_params(jc, tc)
    to, ts = tc.unroll(4, nd.array(x, ctx=CPU), layout="NTC",
                       merge_outputs=True)
    onp.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=TOL,
                                atol=TOL)
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        onp.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=TOL,
                                    atol=TOL)
    assert tc.state_info(4) == jc.state_info(4)


def test_gluon_cell_unroll_equals_the_fused_layer():
    """An LSTMCell unrolled over a sequence equals a one-layer LSTM with
    its weights."""
    cell = mx.gluon.rnn.LSTMCell(6, input_size=5, prefix="c_")
    cell.initialize(mx.init.Xavier(), ctx=CPU)
    layer = mx.gluon.rnn.LSTM(6, input_size=5, layout="NTC", prefix="f_")
    layer.initialize(ctx=CPU)
    cp = cell.collect_params()
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        layer.collect_params()[f"f_l0_{name}"].set_data(
            cp[f"c_{name}"].data())
    x = nd.array(onp.random.RandomState(6).randn(3, 4, 5).astype("f"),
                 ctx=CPU)
    outs, (h, c) = cell.unroll(4, x, layout="NTC", merge_outputs=True)
    fo, (fh, fc) = layer(x, layer.begin_state(3, ctx=CPU))
    onp.testing.assert_allclose(outs.asnumpy(), fo.asnumpy(), rtol=TOL,
                                atol=TOL)
    onp.testing.assert_allclose(h.asnumpy(), fh.asnumpy()[0], rtol=TOL,
                                atol=TOL)
    onp.testing.assert_allclose(c.asnumpy(), fc.asnumpy()[0], rtol=TOL,
                                atol=TOL)


def test_gluon_cell_row_shapes_and_begin_state():
    cell = mx.gluon.rnn.GRUCell(7)
    assert cell.state_row_shapes() == [(7,)]
    st = cell.begin_state(2, ctx=CPU)
    assert [s.shape for s in st] == [(2, 7)]
    with pytest.raises(NotImplementedError):
        mx.gluon.rnn.BidirectionalCell(cell, mx.gluon.rnn.GRUCell(7))(
            nd.zeros((2, 3), ctx=CPU), st)


# -- the bucketed sentence iterator ------------------------------------------


def test_bucket_sentence_iter_matches_jax():
    rs = onp.random.RandomState(0)
    sents = [list(rs.randint(1, 30, rs.randint(2, 13))) for _ in range(80)]
    batches = []
    for pkg in (jmx, mx):
        random.seed(3)
        onp.random.seed(3)
        it = pkg.rnn.BucketSentenceIter(sents, 4, buckets=[4, 8, 12],
                                        invalid_label=0)
        batches.append((it, [(b.bucket_key, b.data[0].asnumpy(),
                              b.label[0].asnumpy(), b.provide_data[0].shape)
                             for b in it]))
    (jit, jb), (tit, tb) = batches
    assert tit.default_bucket_key == jit.default_bucket_key == 12
    assert [d.shape for d in tit.provide_data] == \
        [d.shape for d in jit.provide_data]
    assert len(tb) == len(jb) > 0
    for a, b in zip(jb, tb):
        assert a[0] == b[0] and a[3] == b[3]
        onp.testing.assert_array_equal(a[1], b[1])
        onp.testing.assert_array_equal(a[2], b[2])
    tit.reset()
    assert next(tit).data[0].context == CPU


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "c"], ["b", "d"], ["e"]]
    jr, jv = jmx.rnn.encode_sentences(sents, invalid_label=0, start_label=0)
    tr, tv = mx.rnn.encode_sentences(sents, invalid_label=0, start_label=0)
    assert tr == jr and tv == jv
    with pytest.raises(ValueError):
        mx.rnn.encode_sentences([["z"]], vocab=dict(tv))


def test_gluon_rnn_layer_weights_load_through_convert():
    """A JAX Gluon RNN layer's parameters, as numpy by structural name,
    load into the port's layer with ``convert.params_from_numpy``."""
    from mxnet_tpu_torch import convert

    jl = jmx.gluon.rnn.LSTM(6, num_layers=2, bidirectional=True,
                            input_size=4, prefix="lstm_")
    jl.initialize(jmx.init.Xavier())
    arrays = {k: v.data().asnumpy()
              for k, v in jl._collect_params_with_prefix().items()}
    assert "l0_i2h_weight" in arrays and "r1_h2h_bias" in arrays
    tl = mx.gluon.rnn.LSTM(6, num_layers=2, bidirectional=True, input_size=4,
                           prefix="lstm_")
    convert.params_from_numpy(tl, arrays, ctx=CPU)
    x = onp.random.RandomState(8).randn(3, 2, 4).astype("f")
    onp.testing.assert_allclose(tl(nd.array(x, ctx=CPU)).asnumpy(),
                                jl(jnd.array(x)).asnumpy(), rtol=TOL,
                                atol=TOL)
