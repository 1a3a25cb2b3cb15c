"""Paged decode serving and the session's step buckets in the port, on the
CPU.

The oracle is the port's own explicit-state loop (``session.step``) at
the same occupancy bucket, as in ``test_torch_serving.py``: with one
bucket every step runs the same matmul shapes, so the batcher's outputs
must be BITWISE equal to the loop's, whichever streams share a step.
Paged and row-slot stores hand the step the same dense rows, so paged
decode must be bitwise equal to row-slot decode too: a difference is a
bug, not noise. The JAX package's ``parse_buckets`` is the reference
for the bucket policy (exact).
"""
import numpy as onp
import pytest

from mxnet_tpu.serving import session as jsession
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, serving
from mxnet_tpu_torch.models import DecoderBlockLM
from mxnet_tpu_torch.resilience import faults

VOCAB, EMBED, LAYERS, HEADS, MAXLEN = 32, 16, 2, 2, 16
TIMEOUT_S = 60


@pytest.fixture(scope="module")
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

    def build(page_tokens=4, max_sessions=4, buckets=(4,), byte_budget=0):
        store = serving.SessionStateStore(
            net.state_row_shapes(), net.state_row_dtypes(),
            max_sessions=max_sessions, byte_budget=byte_budget, ttl_s=0,
            pageable=net.state_row_pageable(), page_tokens=page_tokens,
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


def _streams(seed, lengths):
    rs = onp.random.RandomState(seed)
    return {f"s{i}": [rs.randint(0, VOCAB, size=(1, 1)).astype("int32")
                      for _ in range(n)] for i, n in enumerate(lengths)}


def _serve(bat, streams):
    futs = {sid: [bat.submit(t, session_id=sid, slo_class="standard")
                  for t in toks] for sid, toks in streams.items()}
    return {sid: [onp.asarray(f.result(timeout=TIMEOUT_S)) for f in fs]
            for sid, fs in futs.items()}


def _oracle(sess, tokens):
    states = [onp.zeros((1,) + s, dt) for s, dt in
              zip(sess._block.state_row_shapes(),
                  sess._block.state_row_dtypes())]
    outs = []
    for tok in tokens:
        out, states = sess.step(tok, states=states)
        outs.append(out.asnumpy())
    return outs


def test_paged_decode_bitwise_vs_row_slot_and_step_loop(stack):
    """Streams of 3, 9 and 16 tokens (the last fills the whole cache)
    cross the 4-token page boundaries: the paged batcher's logits equal
    the row-slot batcher's and the explicit-state loop's bit for bit,
    and so do the stores' dense rows."""
    streams = _streams(1, [3, 9, MAXLEN])
    pstore, psess, pbat = stack(page_tokens=4)
    rstore, _, rbat = stack(page_tokens=0)
    assert pstore.paged and not rstore.paged
    serving.METRICS.reset()
    paged = _serve(pbat, streams)
    snap = serving.METRICS.snapshot()
    rows = _serve(rbat, streams)
    for sid, toks in streams.items():
        want = _oracle(psess, toks)
        for p, r, w in zip(paged[sid], rows[sid], want):
            assert p.shape == (1, VOCAB)
            assert onp.array_equal(p, r) and onp.array_equal(p, w)
        for a, b in zip(pstore.read(sid), rstore.read(sid)):
            assert onp.array_equal(a, b)
        assert pstore.read(sid)[-1].item() == len(toks)
    assert pstore.stats()["pages_used"] == 1 + 3 + 4
    # the store's page probe, as the registry samples it
    probe = pstore._page_probe()
    assert probe["pages_used"] == 8 and probe["pages_total"] == 16
    assert sorted(probe["pages_per_session"]) == [1, 3, 4]
    assert snap["kv_pages_used"] >= 8
    assert snap["responses"] == sum(map(len, streams.values()))
    assert snap["responses:standard"] == snap["responses"]


def test_paged_store_admits_more_streams_in_the_same_budget(stack, net):
    """A budget that holds two worst-case rows serves six short paged
    streams at once, with no eviction."""
    budget = 2 * serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=1,
        byte_budget=0, ctx=mx.cpu()).bytes_per_session
    rstore, _, _ = stack(page_tokens=0, max_sessions=8, byte_budget=budget)
    pstore, _, pbat = stack(page_tokens=4, max_sessions=8, buckets=(8,),
                            byte_budget=budget)
    assert rstore.num_slots == 2 and pstore.num_slots >= 6
    serving.METRICS.reset()
    _serve(pbat, _streams(2, [4] * 6))
    assert sorted(pstore.live_sessions()) == [f"s{i}" for i in range(6)]
    assert serving.METRICS.snapshot()["evictions"] == 0
    assert pstore.stats()["pages_used"] == 6


def test_join_mid_flight_across_buckets_matches_loop(stack):
    """Buckets 1, 2, 4: each step runs at the bucket its occupancy needs
    and the oracle at bucket 1, so rows agree within 1e-6 (row-independent
    arithmetic at different matmul shapes), as in the row-slot test."""
    store, sess, bat = stack(page_tokens=4, buckets=(1, 2, 4))
    early, late = _streams(4, [10])["s0"], _streams(5, [6])["s0"]
    f_early = [bat.submit(t, session_id="early") for t in early]
    f_early[3].result(timeout=TIMEOUT_S)
    f_late = [bat.submit(t, session_id="late") for t in late]
    for fs, toks in ((f_early, early), (f_late, late)):
        for f, w in zip(fs, _oracle(sess, toks)):
            onp.testing.assert_allclose(onp.asarray(f.result(TIMEOUT_S)), w,
                                        rtol=1e-6, atol=1e-6)
    assert sess.graph_stats() == {b: {"graph": False, "replays": 0}
                                  for b in (1, 2, 4)}


def test_failed_step_leaves_states_and_retries_bitwise(stack):
    """An injected ``serving_execute`` failure rejects every member of
    that step and advances no state; the retried steps equal the
    loop."""
    store, sess, bat = stack(page_tokens=4)
    toks = _streams(6, [5])["s0"]
    for t in toks[:2]:
        bat.submit(t, session_id="a").result(timeout=TIMEOUT_S)
    before = store.read("a")
    with faults.inject("serving_execute", every=1):
        with pytest.raises(faults.InjectedFault):
            bat.submit(toks[2], session_id="a").result(timeout=TIMEOUT_S)
    for x, y in zip(before, store.read("a")):
        assert onp.array_equal(x, y)
    got = [onp.asarray(bat.submit(t, session_id="a").result(TIMEOUT_S))
           for t in toks[2:]]
    for g, w in zip(got, _oracle(sess, toks)[2:]):
        assert onp.array_equal(g, w)


def test_session_owned_store_follows_the_block(net, monkeypatch):
    """``state_shapes=`` builds a store whose pageable rows are the
    block's, paged once MXNET_SERVING_STATE_PAGE_TOKENS is set."""
    monkeypatch.setenv("MXNET_SERVING_STATE_PAGE_TOKENS", "4")
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_shapes=net.state_row_shapes(),
        state_dtypes=net.state_row_dtypes(), buckets=[2], ctx=mx.cpu())
    try:
        assert sess.state_store.paged
        assert sess.state_store.num_pages == 64 * (MAXLEN // 4)
        assert sess.health_snapshot()["warm"]
    finally:
        sess.close()


def test_graphs_need_a_cuda_device(net):
    with pytest.raises(mx.MXNetError, match="CUDA"):
        serving.InferenceSession(
            net, input_shapes=[(1, 1)], input_dtypes=["int32"],
            state_shapes=net.state_row_shapes(),
            state_dtypes=net.state_row_dtypes(), graphs=True, ctx=mx.cpu())


@pytest.mark.parametrize("raw,max_batch", [
    (None, 32), ("pow2", 24), ("mult:8", 32), ("mult:5", 12),
    ("1,4,16", 16), (" 3,1 ", 8)])
def test_parse_buckets_matches_reference(raw, max_batch):
    assert serving.parse_buckets(raw, max_batch) == \
        jsession.parse_buckets(raw, max_batch)


@pytest.mark.parametrize("raw", ["mult:0", "1,x", "0,2", "1,64"])
def test_parse_buckets_refuses_as_reference(raw):
    with pytest.raises(jsession.MXNetError):
        jsession.parse_buckets(raw, 32)
    with pytest.raises(mx.MXNetError):
        serving.parse_buckets(raw, 32)


def test_session_buckets_from_env(monkeypatch, net):
    monkeypatch.setenv("MXNET_SERVING_BUCKETS", "mult:3")
    monkeypatch.setenv("MXNET_SERVING_MAX_BATCH", "9")
    dense = gluon.nn.Dense(3, in_units=4)
    dense.initialize(ctx=mx.cpu())
    sess = serving.InferenceSession(dense, input_shapes=[(1, 4)],
                                    ctx=mx.cpu())
    assert sess.buckets == [3, 6, 9]


def test_stateless_batcher_coalesces_and_matches_predict():
    """Concurrent stateless requests coalesce into one bucket execution
    and each gets its own rows back, equal to ``predict`` on them."""
    mx.random.seed(3)
    dense = gluon.nn.Dense(5, in_units=7)
    dense.initialize(ctx=mx.cpu())
    sess = serving.InferenceSession(dense, input_shapes=[(1, 7)],
                                    buckets=[8], ctx=mx.cpu())
    rs = onp.random.RandomState(0)
    reqs = [rs.randn(n, 7).astype("float32") for n in (1, 3, 2)]
    serving.METRICS.reset()
    with serving.DynamicBatcher(sess, max_batch_size=8,
                                max_latency_ms=200.0,
                                admission=False) as bat:
        futs = [bat.submit(r) for r in reqs]
        got = [f.result(timeout=TIMEOUT_S) for f in futs]
        with pytest.raises(ValueError, match="session_id"):
            bat.submit(reqs[0], session_id="x")
        with pytest.raises(ValueError, match="exceeds max_batch_size"):
            bat.submit(rs.randn(9, 7).astype("float32"))
    snap = serving.METRICS.snapshot()
    whole = sess.predict(onp.concatenate(reqs)).asnumpy()
    offsets = onp.cumsum([0] + [len(r) for r in reqs])
    for r, g, o in zip(reqs, got, offsets):
        assert g.shape == (len(r), 5)
        assert onp.array_equal(g, whole[o:o + len(r)])
    assert snap["batches"] == 1 and snap["true_rows"] == 6
    assert snap["padded_rows"] == 2 and snap["invalid"] == 2


def test_batcher_runs_inline_when_serving_is_off(monkeypatch, stack):
    monkeypatch.setenv("MXNET_SERVING", "0")
    store, sess, bat = stack(page_tokens=4)
    toks = _streams(7, [3])["s0"]
    serving.METRICS.reset()
    got = [onp.asarray(bat.submit(t, session_id="z").result(0))
           for t in toks]
    assert serving.METRICS.snapshot()["inline"] == 3
    for g, w in zip(got, _oracle(sess, toks)):
        assert onp.array_equal(g, w)


def test_close_drains_and_wait_idle(stack):
    store, sess, bat = stack(page_tokens=4)
    toks = _streams(8, [6])["s0"]
    futs = [bat.submit(t, session_id="d") for t in toks]
    assert bat.wait_idle(TIMEOUT_S)
    assert all(f.done() for f in futs)
    bat.close()
    assert onp.array_equal(onp.asarray(futs[-1].result()),
                           _oracle(sess, toks)[-1])
