"""Stateful decode serving in the PyTorch port, on the CPU.

The oracle is the port's own explicit-state loop, ``session.step``, at
the same occupancy bucket: with one bucket every step runs the same
matmul shapes, so the batcher's outputs must be **bitwise** equal to
the loop's, whichever streams share a step. The JAX serving stack is
not used (its stateful tests fail on this container).
"""
import time

import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.models import DecoderBlockLM

VOCAB, EMBED, LAYERS, HEADS, MAXLEN = 32, 16, 2, 2, 16
TIMEOUT_S = 60


@pytest.fixture
def net():
    mx.random.seed(16)
    net = DecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                         num_heads=HEADS, max_len=MAXLEN)
    net.initialize(ctx=mx.cpu())
    return net


@pytest.fixture
def stack(net):
    """(store, session, batcher) factory; everything is closed after."""
    made = []

    def build(max_sessions=4, ttl_s=0, buckets=(4,)):
        store = serving.SessionStateStore(
            net.state_row_shapes(), net.state_row_dtypes(),
            max_sessions=max_sessions, byte_budget=0, ttl_s=ttl_s,
            ctx=mx.cpu())
        sess = serving.InferenceSession(
            net, input_shapes=[(1, 1)], input_dtypes=["int32"],
            state_store=store, buckets=list(buckets), ctx=mx.cpu())
        bat = serving.DynamicBatcher(sess, max_batch_size=max(buckets),
                                     max_latency_ms=2.0,
                                     timeout_ms=TIMEOUT_S * 1e3,
                                     admission=False)
        made.append((store, sess, bat))
        return store, sess, bat

    yield build
    for store, sess, bat in made:
        bat.close()
        sess.close()
        store.close()


def _tokens(seed, n):
    rs = onp.random.RandomState(seed)
    return [rs.randint(0, VOCAB, size=(1, 1)).astype("int32")
            for _ in range(n)]


def _oracle(sess, tokens):
    """Every step's logits of the explicit-state loop from zero state."""
    states = [onp.zeros((1,) + s, dt) for s, dt in
              zip(sess._block.state_row_shapes(),
                  sess._block.state_row_dtypes())]
    outs = []
    for tok in tokens:
        out, states = sess.step(tok, states=states)
        outs.append(out.asnumpy())
    return outs


def test_mixed_length_streams_bitwise_vs_step_loop(stack):
    store, sess, bat = stack()
    streams = {"a": _tokens(1, 3), "b": _tokens(2, 7), "c": _tokens(3, 12)}
    serving.METRICS.reset()
    futs = {sid: [bat.submit(t, session_id=sid) for t in toks]
            for sid, toks in streams.items()}
    got = {sid: [onp.asarray(f.result(timeout=TIMEOUT_S)) for f in fs]
           for sid, fs in futs.items()}
    snap = serving.METRICS.snapshot()
    for sid, toks in streams.items():
        want = _oracle(sess, toks)
        assert len(got[sid]) == len(want)
        for g, w in zip(got[sid], want):
            assert g.shape == (1, VOCAB)
            assert onp.array_equal(g, w)
        assert store.read(sid)[-1].item() == len(toks)
    # counters of the batcher's steps (read before the oracle's steps)
    n_tokens = sum(len(t) for t in streams.values())
    assert snap["responses"] == n_tokens and snap["failures"] == 0
    assert snap["true_rows"] == n_tokens
    assert snap["bucket_execs"] == snap["decode_steps"] >= 12
    assert snap["padded_rows"] == 4 * snap["decode_steps"] - n_tokens


def test_streams_join_mid_flight_bitwise(stack):
    """A stream that joins while others are mid-decode, across mixed
    buckets: the batch re-forms at step boundaries and every stream still
    equals its own loop (each step's bucket is whatever its occupancy
    needs, so here the oracle runs at bucket 1 and tolerance is exact
    only if the matmul is row-independent — checked at 1e-6)."""
    store, sess, bat = stack(buckets=(1, 2, 4))
    early, late = _tokens(4, 10), _tokens(5, 6)
    f_early = [bat.submit(t, session_id="early") for t in early]
    f_early[3].result(timeout=TIMEOUT_S)
    f_late = [bat.submit(t, session_id="late") for t in late]
    for fs, toks in ((f_early, early), (f_late, late)):
        for f, w in zip(fs, _oracle(sess, toks)):
            onp.testing.assert_allclose(onp.asarray(f.result(TIMEOUT_S)), w,
                                        rtol=1e-6, atol=1e-6)


def test_eviction_then_clean_reopen(stack):
    store, sess, bat = stack(max_sessions=2)
    toks = {sid: _tokens(10 + i, 4) for i, sid in enumerate("abc")}
    for sid in "ab":
        for t in toks[sid]:
            bat.submit(t, session_id=sid).result(timeout=TIMEOUT_S)
    # a third stream needs a slot: the least recently stepped ("a") goes
    bat.submit(toks["c"][0], session_id="c").result(timeout=TIMEOUT_S)
    assert sorted(store.live_sessions()) == ["b", "c"]
    with pytest.raises(serving.SessionEvicted, match="re-open"):
        bat.submit(toks["a"][0], session_id="a").result(timeout=TIMEOUT_S)
    # an explicit re-open restarts from zero state: the replay is bitwise
    store.evict("c")
    store.open("a")
    got = [onp.asarray(bat.submit(t, session_id="a").result(TIMEOUT_S))
           for t in toks["a"]]
    for g, w in zip(got, _oracle(sess, toks["a"])):
        assert onp.array_equal(g, w)


def test_session_failure_rejects_only_that_future(stack):
    store, sess, bat = stack()
    toks = _tokens(20, 3)
    for t in toks[:2]:
        bat.submit(t, session_id="ok").result(timeout=TIMEOUT_S)
    bat.submit(toks[0], session_id="gone").result(timeout=TIMEOUT_S)
    store.evict("gone")
    f_gone = bat.submit(toks[1], session_id="gone")
    f_ok = bat.submit(toks[2], session_id="ok")
    with pytest.raises(serving.SessionEvicted):
        f_gone.result(timeout=TIMEOUT_S)
    assert onp.array_equal(onp.asarray(f_ok.result(timeout=TIMEOUT_S)),
                           _oracle(sess, toks)[-1])


def test_ttl_expiry_evicts_idle_session(stack):
    store, _, _ = stack(ttl_s=0.05)
    store.open("idle")
    time.sleep(0.1)
    with pytest.raises(serving.SessionEvicted, match="expired"):
        store.acquire("idle")
    assert not store.has("idle")


def test_step_leaves_callers_states_untouched(stack, net):
    _, sess, _ = stack()
    rs = onp.random.RandomState(0)
    rows = [rs.randn(2, *s).astype(dt) for s, dt in
            zip(net.state_row_shapes(), net.state_row_dtypes())]
    rows[-1] = onp.array([[3], [5]], "int32")
    mine = [mx.nd.array(r, ctx=mx.cpu(), dtype=r.dtype) for r in rows]
    before = [m.asnumpy() for m in mine]
    _, news = sess.step(onp.array([[1], [2]], "int32"), states=mine)
    for m, b in zip(mine, before):
        assert onp.array_equal(m.asnumpy(), b)
    assert not onp.array_equal(news[0].asnumpy(), before[0])
    assert news[-1].asnumpy().ravel().tolist() == [4, 6]


def test_gather_pads_with_zero_rows(stack):
    store, _, _ = stack()
    rows = [onp.ones(s, dt) for s, dt in
            zip(store.state_shapes, store.state_dtypes)]
    store.open("x", init_states=rows)
    rec = store.acquire("x")
    try:
        got = store.gather([rec], pad_to=4)
    finally:
        store.release(rec, stepped=False)
    for g in got:
        assert g.shape[0] == 4
        assert (g[0] == 1).all() and not g[1:].any()


def test_submit_validates_per_request(stack):
    _, _, bat = stack()
    with pytest.raises(ValueError, match="session_id"):
        bat.submit(onp.zeros((1, 1), "int32"))
    with pytest.raises(ValueError, match="one row"):
        bat.submit(onp.zeros((2, 1), "int32"), session_id="s")
    with pytest.raises(ValueError, match="row shape"):
        bat.submit(onp.zeros((1, 2), "int32"), session_id="s")


def test_close_drains_accepted_steps(stack):
    _, sess, bat = stack()
    toks = _tokens(30, 5)
    futs = [bat.submit(t, session_id="d") for t in toks]
    bat.close()
    assert all(f.done() for f in futs)
    assert onp.array_equal(onp.asarray(futs[-1].result()),
                           _oracle(sess, toks)[-1])
