"""The Module family on the CPU: the port against the JAX package.

The same numpy-seeded data and the JAX module's initial weights (copied,
never redrawn) go through both packages: ``Module.fit`` (final weights,
the training metric), ``score`` and ``predict``; per-step outputs of the
LSTM word-LM (``tools/profile_module.py``) under truncated BPTT;
``BucketingModule`` over two buckets of ``rnn.LSTMCell.unroll``;
``SequentialModule`` with a ``PythonLossModule`` head. Everything within
1e-5 (float32 sums in other orders). Checkpoints interchange: each
package reads the other's ``-symbol.json`` and ``.params``, byte for
byte the same. The kvstore rule is pinned: the port holds no store
where the JAX module makes one ``update()`` never uses.
"""
import os
import pickle
import random

import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, nd
from mxnet_tpu_torch.tools import profile_module as pm

CPU = mx.cpu()
TOL = 1e-5
SMALL_MLP = dict(hidden=(16, 8), classes=4)


def _mlp_data(n=64, features=10, seed=0):
    return pm.mlp_data(n, features=features, classes=4, seed=seed)


def _iter(pkg, X, y, batch=16, **kw):
    return pkg.io.NDArrayIter(X, y, batch_size=batch,
                              label_name="softmax_label", **kw)


def _mlp_pair(X, y, batch=16):
    """A bound JAX module with Xavier weights and a port module holding
    the same weights."""
    jm = jmx.mod.Module(pm.mlp_symbol(jmx.sym, **SMALL_MLP))
    jit = _iter(jmx, X, y, batch)
    jm.bind(jit.provide_data, jit.provide_label)
    jm.init_params(jmx.init.Xavier())
    tm = mx.mod.Module(pm.mlp_symbol(mx.sym, **SMALL_MLP), context=CPU)
    tit = _iter(mx, X, y, batch)
    tm.bind(tit.provide_data, tit.provide_label)
    args, aux = jm.get_params()
    convert.module_params_from_numpy(
        tm, {k: v.asnumpy() for k, v in args.items()})
    return jm, tm


def _assert_params(jm, tm, tol=TOL):
    ja, jx = jm.get_params()
    ta, tx = tm.get_params()
    assert set(ja) == set(ta) and set(jx) == set(tx)
    for k in ja:
        onp.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                    rtol=tol, atol=tol)


def test_fit_score_and_predict_match_jax():
    X, y = _mlp_data(70)
    jm, tm = _mlp_pair(X, y)
    jmet, tmet = [], []
    for m, pkg, log in ((jm, jmx, jmet), (tm, mx, tmet)):
        m.fit(_iter(pkg, X, y), optimizer="sgd",
              optimizer_params={"learning_rate": 0.3, "momentum": 0.9},
              num_epoch=3, eval_metric="acc",
              batch_end_callback=lambda p, log=log:
                  log.append(p.eval_metric.get()[1]))
    _assert_params(jm, tm)
    onp.testing.assert_allclose(tmet, jmet, rtol=TOL)
    js = dict(jm.score(_iter(jmx, X, y), ["acc", "ce"]))
    ts = dict(tm.score(_iter(mx, X, y), ["acc", "ce"]))
    assert set(ts) == set(js)
    for k in js:
        onp.testing.assert_allclose(ts[k], js[k], rtol=TOL)
    jp = jm.predict(_iter(jmx, X, y))
    tp = tm.predict(_iter(mx, X, y))
    assert tp.shape == jp.shape == (70, 4)
    onp.testing.assert_allclose(tp.asnumpy(), jp.asnumpy(), rtol=TOL,
                                atol=TOL)
    assert len(tm.predict(_iter(mx, X, y), merge_batches=False)) == 5


def test_fit_without_a_metric_and_forward_backward_steps():
    X, y = _mlp_data()
    jm, tm = _mlp_pair(X, y)
    for m, pkg in ((jm, jmx), (tm, mx)):
        m.init_optimizer(optimizer="adam",
                         optimizer_params={"learning_rate": 0.01})
    for jb, tb in zip(_iter(jmx, X, y), _iter(mx, X, y)):
        jm.forward_backward(jb)
        jm.update()
        tm.forward_backward(tb)
        tm.update()
        onp.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                                    jm.get_outputs()[0].asnumpy(), rtol=TOL,
                                    atol=TOL)
    _assert_params(jm, tm)
    m = mx.mod.Module(pm.mlp_symbol(mx.sym, **SMALL_MLP), context=CPU)
    m.fit(_iter(mx, X, y), eval_metric=None, num_epoch=1)
    assert m.params_initialized and m.output_shapes == [
        ("softmax_output", (16, 4))]


def test_checkpoints_interchange_with_the_jax_package(tmp_path):
    X, y = _mlp_data()
    jm, tm = _mlp_pair(X, y)
    tm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1,
                                        "momentum": 0.9})
    tm.forward_backward(next(iter(_iter(mx, X, y))))
    tm.update()
    tp, jp = str(tmp_path / "port"), str(tmp_path / "jax")
    tm.save_checkpoint(tp, 3, save_optimizer_states=True)
    args, aux = tm.get_params()
    jmx.model.save_checkpoint(jp, 3, jm.symbol,
                              {k: jmx.nd.array(v.asnumpy())
                               for k, v in args.items()}, {})
    with open(f"{tp}-0003.params", "rb") as a, \
            open(f"{jp}-0003.params", "rb") as b:
        assert a.read() == b.read()
    with open(f"{tp}-symbol.json") as a, open(f"{jp}-symbol.json") as b:
        assert a.read() == b.read()
    s, ja, _ = jmx.model.load_checkpoint(tp, 3)
    assert s.list_arguments() == tm.symbol.list_arguments()
    for k in args:
        onp.testing.assert_array_equal(ja[k].asnumpy(), args[k].asnumpy())
    s2, ta, tx = mx.model.load_checkpoint(jp, 3, ctx=CPU)
    assert s2.tojson() == tm.symbol.tojson() and tx == {}
    loaded = mx.mod.Module.load(tp, 3, context=CPU)
    it = _iter(mx, X, y)
    loaded.bind(it.provide_data, it.provide_label)
    loaded.init_params()
    _assert_params(tm, loaded, tol=0)
    with open(f"{tp}-0003.states", "rb") as f:
        states = pickle.loads(f.read())
    assert sorted(states) == [0, 1, 2, 3, 4, 5]
    assert states[0].shape == args["fc1_weight"].shape


def _word_lm_cfg():
    return dict(vocab=40, embed=12, hidden=12, layers=2, dropout=0.0,
                bptt=5, batch=3)


def test_word_lm_module_matches_jax_under_truncated_bptt():
    """The fused-RNN word-LM, states carried batch to batch through
    ``BlockGrad`` outputs, SGD with a clipped gradient: per-step softmax
    outputs, the Perplexity metric and the final weights."""
    cfg = _word_lm_cfg()
    toks = pm.markov_tokens(cfg["bptt"] * cfg["batch"] * 4 + 1,
                            cfg["vocab"], 0)
    batches = pm.bptt_batches(toks, cfg["bptt"], cfg["batch"])
    assert len(batches) == 4
    tm = pm.word_lm_module(mx, cfg, CPU)
    w0 = {k: v.asnumpy() for k, v in tm.get_params()[0].items()}
    assert set(w0) == {"embed_weight", "lstm_parameters", "decoder_bias"}
    jm = pm.word_lm_module(jmx, cfg, jmx.cpu(), arg_params=w0)
    jmet, tmet = jmx.metric.Perplexity(), mx.metric.Perplexity()
    jstates = tstates = None
    for b in batches:
        _, jstates = pm.word_lm_train(jmx, jm, [b], cfg, jmx.cpu(),
                                      metric=jmet, states=jstates)
        _, tstates = pm.word_lm_train(mx, tm, [b], cfg, CPU, metric=tmet,
                                      states=tstates)
        for a, c in zip(jm.get_outputs(), tm.get_outputs()):
            onp.testing.assert_allclose(c.asnumpy(), a.asnumpy(), rtol=TOL,
                                        atol=TOL)
    onp.testing.assert_allclose(tmet.get()[1], jmet.get()[1], rtol=TOL)
    _assert_params(jm, tm)
    assert tm.output_names == ["softmax_output", "h_last_output",
                               "c_last_output"]


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    """The word-LM's global-norm clip on either package's NDArrays: each
    array scaled in place by min(1, max_norm / the global norm)."""
    rs = onp.random.RandomState(0)
    vals = [rs.randn(3, 4).astype("f"), rs.randn(5).astype("f")]
    got = []
    for m, ctx in ((jmx, jmx.cpu()), (mx, CPU)):
        arrs = [m.nd.array(v, ctx=ctx) for v in vals]
        pm.clip_global_norm(m, arrs, max_norm)
        got.append([a.asnumpy() for a in arrs])
    norm = onp.sqrt(sum(float((v.astype("f8") ** 2).sum()) for v in vals))
    for j, t, v in zip(*got, vals):
        onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
        onp.testing.assert_allclose(t, v * min(1.0, max_norm / norm),
                                    rtol=TOL, atol=TOL)


def test_bucketing_module_two_buckets_match_jax():
    V, H, B = 20, 8, 4
    rs = onp.random.RandomState(0)
    sents = [list(rs.randint(1, V, rs.randint(3, 9))) for _ in range(40)]
    its = []
    for pkg in (jmx, mx):
        random.seed(1)
        onp.random.seed(1)
        its.append(pkg.rnn.BucketSentenceIter(sents, B, buckets=[4, 8],
                                              invalid_label=0))
    jit, tit = its
    jm = jmx.mod.BucketingModule(pm.bucketing_sym_gen(jmx, V, H, B),
                                 default_bucket_key=8)
    tm = mx.mod.BucketingModule(pm.bucketing_sym_gen(mx, V, H, B),
                                default_bucket_key=8, context=CPU)
    jm.bind(jit.provide_data, jit.provide_label)
    tm.bind(tit.provide_data, tit.provide_label)
    jm.init_params(jmx.init.Xavier())
    tm.init_params(arg_params={k: nd.array(v.asnumpy(), ctx=CPU)
                               for k, v in jm.get_params()[0].items()})
    for m in (jm, tm):
        m.init_optimizer(optimizer="adam",
                         optimizer_params={"learning_rate": 0.01})
    keys = set()
    for jb, tb in zip(jit, tit):
        assert jb.bucket_key == tb.bucket_key
        keys.add(tb.bucket_key)
        for m, b in ((jm, jb), (tm, tb)):
            m.forward_backward(b)
            m.update()
        onp.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                                    jm.get_outputs()[0].asnumpy(), rtol=TOL,
                                    atol=TOL)
    assert keys == {4, 8}
    _assert_params(jm, tm)
    info = tm.graph_info()
    assert set(info) == {4, 8} and all(v == [] for v in info.values())
    assert tm.warmup_buckets([(4, [("data", (B, 4))],
                               [("softmax_label", (B, 4))])]) == 1


def _seq_pair():
    out = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, CPU)):
        S = pkg.sym
        feat = S.Activation(S.FullyConnected(
            S.Variable("data"), num_hidden=8, name="fc1",
            weight=S.Variable("fc1_weight"), bias=S.Variable("fc1_bias")),
            act_type="relu", name="relu1")
        head = S.SoftmaxOutput(S.FullyConnected(
            S.Variable("feat"), num_hidden=4, name="fc2",
            weight=S.Variable("fc2_weight"), bias=S.Variable("fc2_bias")),
            S.Variable("softmax_label"), name="softmax")
        kw = {} if pkg is jmx else {"context": ctx}
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(feat, label_names=(), **kw))
        seq.add(pkg.mod.Module(head, data_names=("feat",), **kw),
                take_labels=True, auto_wiring=True)
        out.append(seq)
    return out


def test_sequential_module_matches_jax():
    X, y = _mlp_data()
    js, ts = _seq_pair()
    jit, tit = _iter(jmx, X, y), _iter(mx, X, y)
    js.bind(jit.provide_data, jit.provide_label)
    ts.bind(tit.provide_data, tit.provide_label)
    js.init_params(jmx.init.Xavier())
    ja, _ = js.get_params()
    ts.init_params(arg_params={k: nd.array(v.asnumpy(), ctx=CPU)
                               for k, v in ja.items()})
    for m in (js, ts):
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.5})
    for jb, tb in zip(jit, tit):
        js.forward_backward(jb)
        js.update()
        ts.forward_backward(tb)
        ts.update()
    _assert_params(js, ts)
    assert ts.output_shapes == [("softmax_output", (16, 4))]
    assert ts.label_names == ["softmax_label"]
    jmet, tmet = jmx.metric.create("acc"), mx.metric.create("acc")
    js.update_metric(jmet, jb.label)
    ts.update_metric(tmet, tb.label)
    assert tmet.get() == jmet.get()


def test_python_loss_module_as_a_chain_head_matches_jax():
    X, y = _mlp_data()
    res = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, CPU)):
        S = pkg.sym
        scores = S.FullyConnected(S.Variable("data"), num_hidden=4,
                                  name="fc", weight=S.Variable("fc_weight"),
                                  bias=S.Variable("fc_bias"))
        kw = {} if pkg is jmx else {"context": ctx}
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(scores, label_names=(), **kw))
        seq.add(pkg.mod.PythonLossModule(data_names=("fc_output",)),
                take_labels=True, auto_wiring=True)
        it = _iter(pkg, X, y)
        seq.bind(it.provide_data, it.provide_label)
        rs = onp.random.RandomState(7)
        seq.init_params(arg_params={
            "fc_weight": pkg.nd.array(rs.randn(4, 10).astype("f") * 0.3,
                                      ctx=ctx),
            "fc_bias": pkg.nd.zeros((4,), ctx=ctx)})
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.2})
        for b in it:
            seq.forward_backward(b)
            seq.update()
        res.append({k: v.asnumpy() for k, v in seq.get_params()[0].items()})
    for k in res[0]:
        onp.testing.assert_allclose(res[1][k], res[0][k], rtol=TOL, atol=TOL)
    loss = mx.mod.PythonLossModule()
    loss.bind([("data", (2, 3))], [("softmax_label", (2,))])
    loss.forward(mx.io.DataBatch([nd.zeros((2, 3), ctx=CPU)], None))
    with pytest.raises(ValueError, match="needs labels"):
        loss.backward()


def test_kvstore_is_local_only_and_holds_no_store():
    """The port's Module makes and holds its kvstore as the JAX module
    does (``mxnet_tpu/module/module.py:236-238``): a type name is
    created, a KVStore is held, None holds none; ``dist*`` stores
    included. In one process a dist store's update is the local one."""
    X, y = _mlp_data()
    jm, tm = _mlp_pair(X, y)
    for kv in ("local", "device", "dist_sync", "dist_device_sync"):
        jm.init_optimizer(kvstore=kv, force_init=True)
        tm.init_optimizer(kvstore=kv, force_init=True)
        assert jm._kvstore.type == tm._kvstore.type == kv
        assert tm.optimizer_initialized
    tm.init_optimizer(kvstore=None, force_init=True)
    assert tm._kvstore is None
    store = mx.kv.create("local")
    tm.init_optimizer(kvstore=store, force_init=True)
    assert tm._kvstore is store
    with pytest.raises(mx.MXNetError, match="kvstore must be"):
        tm.init_optimizer(kvstore=object(), force_init=True)
    # one update under dist_sync against the JAX module's
    jm.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.1),),
                      force_init=True)
    tm.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.1),),
                      force_init=True)
    jb = next(iter(_iter(jmx, X, y)))
    tb = next(iter(_iter(mx, X, y)))
    for m, b in ((jm, jb), (tm, tb)):
        m.forward(b, is_train=True)
        m.backward()
        m.update()
    _assert_params(jm, tm)


def test_contexts_fixed_params_and_input_grads():
    X, y = _mlp_data()
    sym = pm.mlp_symbol(mx.sym, **SMALL_MLP)
    with pytest.raises(mx.MXNetError, match="multi-device"):
        mx.mod.Module(sym, context=[CPU, CPU])
    with pytest.raises(mx.MXNetError, match="group2ctxs"):
        mx.mod.Module(sym, context=CPU, group2ctxs={"g": mx.gpu(1)})
    assert mx.mod.Module(sym, context=CPU, group2ctxs={"g": CPU})
    if not mx.num_gpus():
        it = _iter(mx, X, y)
        with pytest.raises(mx.MXNetError, match="CUDA"):
            mx.mod.Module(sym).bind(it.provide_data, it.provide_label)
    m = mx.mod.Module(sym, context=CPU, fixed_param_names=["fc1_weight"])
    it = _iter(mx, X, y)
    m.bind(it.provide_data, it.provide_label, inputs_need_grad=True)
    m.init_params(mx.init.Xavier())
    m.init_optimizer(optimizer_params={"learning_rate": 1.0})
    before = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
    m.forward_backward(next(iter(it)))
    m.update()
    after = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
    onp.testing.assert_array_equal(after["fc1_weight"], before["fc1_weight"])
    assert not onp.array_equal(after["fc1_bias"], before["fc1_bias"])
    (g,) = m.get_input_grads()
    assert g.shape == (16, 10) and onp.abs(g.asnumpy()).sum() > 0
    taps = []
    m.install_monitor(lambda name, arr: taps.append(name))
    m.forward(next(iter(it)), is_train=False)
    assert "softmax_output" in taps


def test_module_params_from_numpy_checks_names_and_shapes():
    X, y = _mlp_data()
    jm, tm = _mlp_pair(X, y)
    args = {k: v.asnumpy() for k, v in jm.get_params()[0].items()}
    fresh = mx.mod.Module(pm.mlp_symbol(mx.sym, **SMALL_MLP), context=CPU)
    convert.module_params_from_numpy(fresh, args)
    it = _iter(mx, X, y)
    fresh.bind(it.provide_data, it.provide_label)
    fresh.init_params()
    _assert_params(jm, fresh, tol=0)
    with pytest.raises(mx.MXNetError, match="missing"):
        convert.module_params_from_numpy(
            tm, {k: v for k, v in args.items() if k != "fc1_bias"})
    bad = dict(args, fc1_bias=onp.zeros(3, "f"))
    with pytest.raises(mx.MXNetError, match="shape"):
        convert.module_params_from_numpy(tm, bad)


def test_gradient_requests_follow_the_reference_executor_group():
    """A deliberate difference: the port's Module asks gradients of the
    parameters, of the data only with ``inputs_need_grad``, never of the
    labels (the reference's executor group); the JAX Module binds every
    argument with ``grad_req``."""
    X, y = _mlp_data()
    jm, tm = _mlp_pair(X, y)
    params = {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
              "fc3_weight", "fc3_bias"}
    assert set(jm._exec.grad_dict) == params | {"data", "softmax_label"}
    assert set(tm._exec.grad_dict) == params
    m = mx.mod.Module(pm.mlp_symbol(mx.sym, **SMALL_MLP), context=CPU)
    it = _iter(mx, X, y)
    m.bind(it.provide_data, it.provide_label, inputs_need_grad=True)
    assert set(m._exec.grad_dict) == params | {"data"}
    m2 = mx.mod.Module(pm.mlp_symbol(mx.sym, **SMALL_MLP), context=CPU)
    m2.bind(it.provide_data, it.provide_label, for_training=False)
    assert m2._exec.grad_dict == {}
