"""int8 KV pages in the port's paged state store, on the CPU.

- The store against the JAX package's: the same open / acquire / gather
  / scatter / release sequence over page boundaries gives the same int8
  codes in the pools and the same ``kv_pages_quantized`` count; the
  per-page scales, the gathers and the dense ``read()`` rows within
  1e-6 relative. The JAX store's scatter is a jitted XLA program, which
  computes ``amax / 127`` as ``amax * (1 / 127)``: a scale one float32
  ulp off now and then. The port divides, as the JAX function does when
  it runs eagerly (``test_torch_paged_state.py`` holds the two
  functions bit for bit).
- ``gather(out=)`` into buffers the caller owns (the session's static
  step inputs) equals the gather that allocates, bit for bit, with the
  padding rows zero whatever the buffers held.
- The byte budget counts an int8 page at its own size (codes plus one
  float32 scale), as the JAX store does, so one budget holds more pages.
- Twins of ``tests/test_paged_decode.py``'s int8 cases on the port's
  ``DecoderBlockLM``: decode through the batcher on int8 pages stays
  within 0.1 of the largest float32 logit (the JAX bound) and counts its
  quantized pages; a session exported from a float32 page-16 store and
  restored into an int8 page-64 store keeps its non-pageable rows
  bitwise and its pages and continued decode within 0.1.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu.analysis import quantize as jq
from mxnet_tpu.serving import state as jstate

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.analysis import quantize as tq
from mxnet_tpu_torch.models import DecoderBlockLM
from mxnet_tpu_torch.serving import state as tstate

SEQ, E = 16, 6
SHAPES = [(SEQ, E), (SEQ, E), (1,)]
DTYPES = ["float32", "float32", "int32"]
PAGEABLE = [True, True, False]
VOCAB, EMBED, HEADS, LAYERS = 32, 16, 2, 1
KV_BOUND = 0.1
TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _counters():
    tq.reset_counters()
    jq.reset_counters()
    yield


@pytest.fixture
def stores():
    made = []

    def build(*args, **kw):
        s = tstate.SessionStateStore(*args, ctx=mx.cpu(), **kw)
        made.append(s)
        return s

    yield build
    for s in made:
        s.close()


def _step(store, sids, rs, torch_side):
    """One decode step as the batcher runs it: acquire, gather, write a
    seeded K/V row at each session's position, scatter, release."""
    recs = [store.acquire(s) for s in sids]
    got = store.gather(recs)
    host = [g.numpy().copy() if torch_side else onp.array(g) for g in got]
    rows = rs.standard_normal((len(sids), 2, E)).astype("float32") * \
        rs.uniform(0.1, 4.0)
    new = [h.copy() for h in host]
    for r in range(len(recs)):
        pos = int(host[2][r, 0])
        if pos < SEQ:
            new[0][r, pos] = rows[r, 0]
            new[1][r, pos] = rows[r, 1]
        new[2][r, 0] = pos + 1
    store.scatter(recs, [torch.from_numpy(n) for n in new] if torch_side
                  else new)
    for rec in recs:
        store.release(rec)
    return host


@pytest.mark.parametrize("page_tokens", [4, 8])
def test_int8_store_matches_the_jax_store(stores, page_tokens):
    kw = dict(pageable=PAGEABLE, page_tokens=page_tokens, byte_budget=0,
              max_sessions=3, ttl_s=0, kv_int8=True)
    j = jstate.SessionStateStore(SHAPES, DTYPES, **kw)
    t = stores(SHAPES, DTYPES, **kw)
    try:
        assert t.stats() == j.stats() and t.stats()["kv_int8"] is True
        for s in (j, t):
            s.open("a")
            s.open("b")
        jr, tr = onp.random.RandomState(0), onp.random.RandomState(0)
        for sids in [["a", "b"]] * 9 + [["a"]] * 5:
            jg = _step(j, sids, jr, False)
            tg = _step(t, sids, tr, True)
            for a, b in zip(jg, tg):
                onp.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        assert t.stats() == j.stats()
        for i in range(2):
            assert t._pools[i].dtype == torch.int8
            onp.testing.assert_array_equal(t._pools[i].numpy(),
                                           onp.asarray(j._pools[i]))
            onp.testing.assert_allclose(t._scales[i].numpy(),
                                        onp.asarray(j._scales[i]),
                                        rtol=1e-6, atol=0)
        for sid in ("a", "b"):
            for a, b in zip(j.read(sid), t.read(sid)):
                assert a.dtype == b.dtype
                onp.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        assert tq.counters()["kv_pages_quantized"] == \
            jq.counters()["kv_pages_quantized"] > 0
    finally:
        j.close()


@pytest.mark.parametrize("kv_int8", [False, True])
def test_gather_into_caller_buffers_pads_with_zeros(stores, kv_int8):
    """``gather(out=)`` (what a session gathers into its static step
    inputs) gives the allocating gather's rows bit for bit, dequantized
    from int8 pages, and zeros the padding rows whatever the buffers
    held."""
    t = stores(SHAPES, DTYPES, pageable=PAGEABLE, page_tokens=4,
               byte_budget=0, max_sessions=3, ttl_s=0, kv_int8=kv_int8)
    for sid in ("a", "b", "c"):
        t.open(sid)
    rs = onp.random.RandomState(4)
    for k in range(7):
        _step(t, ["a", "b", "c"] if k % 3 else ["b"], rs, True)
    t.evict("c")
    recs = [t._slots[s] for s in ("b", "a")]
    want = t.gather(recs, pad_to=4)
    got = [torch.full_like(w, 7) for w in want]
    assert t.gather(recs, out=got) is got
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        onp.testing.assert_array_equal(g.numpy(), w.numpy())
        assert not g[2:].any()
    assert got[0][:2].any()
    with pytest.raises(mx.MXNetError, match="cannot hold"):
        t.gather(recs, out=[g[:1] for g in got])


def test_byte_budget_counts_int8_pages_at_their_size(stores):
    budget = 10_000
    for kv_int8 in (False, True):
        kw = dict(pageable=PAGEABLE, page_tokens=4, byte_budget=budget,
                  max_sessions=64, ttl_s=0, kv_int8=kv_int8)
        j = jstate.SessionStateStore(SHAPES, DTYPES, **kw)
        t = stores(SHAPES, DTYPES, **kw)
        try:
            assert t.stats() == j.stats()
            assert (t.num_slots, t.num_pages) == (j.num_slots, j.num_pages)
        finally:
            j.close()
    fp32 = stores(SHAPES, DTYPES, pageable=PAGEABLE, page_tokens=4,
                  byte_budget=budget, ttl_s=0)
    int8 = stores(SHAPES, DTYPES, pageable=PAGEABLE, page_tokens=4,
                  byte_budget=budget, ttl_s=0, kv_int8=True)
    assert int8._page_bytes == 2 * (4 * E + 4)  # codes and a scale each
    assert int8.num_pages > 3 * fp32.num_pages


def test_env_turns_int8_pages_on_for_paged_stores_only(stores, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_STATE_KV_INT8", "1")
    paged = stores(SHAPES, DTYPES, pageable=PAGEABLE, page_tokens=4,
                   byte_budget=0, ttl_s=0)
    rows = stores(SHAPES, DTYPES, pageable=PAGEABLE, page_tokens=0,
                  byte_budget=0, ttl_s=0)
    assert paged.kv_int8 and paged.stats()["kv_int8"] is True
    assert not rows.kv_int8 and rows._pools[0].dtype == torch.float32
    assert paged._pools[0].dtype == torch.int8
    assert paged._pools[2].dtype == torch.int32  # not pageable: as given


def _decoder(max_len, seed):
    mx.random.seed(seed)
    net = DecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                         num_heads=HEADS, max_len=max_len)
    net.initialize(ctx=mx.cpu())
    return net


def _stack(net, page_tokens, **kw):
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=8,
        byte_budget=0, ttl_s=0, pageable=net.state_row_pageable(),
        page_tokens=page_tokens, ctx=mx.cpu(), **kw)
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=[1, 2, 4], ctx=mx.cpu())
    bat = serving.DynamicBatcher(sess, max_batch_size=2, max_latency_ms=2.0,
                                 timeout_ms=TIMEOUT_S * 1e3, admission=False)
    return store, sess, bat


def _close(*stack):
    store, sess, bat = stack
    bat.close()
    sess.close()
    store.close()


def _toks(seed, n):
    return [onp.random.RandomState(seed + t).randint(
        0, VOCAB, size=(1, 1)).astype("int32") for t in range(n)]


def _oracle(sess, toks):
    """The explicit-state loop on float32 client-side states."""
    states = [onp.zeros((1,) + s, dt) for s, dt in
              zip(sess._block.state_row_shapes(),
                  sess._block.state_row_dtypes())]
    out = None
    for x in toks:
        out, states = sess.step(x, states=states)
    return out.asnumpy()


def _dev(a, b):
    return float(onp.abs(a - b).max()) / max(float(onp.abs(b).max()), 1e-6)


def test_int8_kv_pages_accuracy_and_counters():
    """Twin of ``test_int8_kv_pages_accuracy_and_counters``
    (``tests/test_paged_decode.py``)."""
    net = _decoder(16, 21)
    stack = _stack(net, 4, kv_int8=True)
    store, sess, bat = stack
    try:
        assert store.stats()["kv_int8"] is True
        toks = _toks(91, 10)
        for x in toks:
            out = onp.asarray(bat.submit(x, session_id="q").result(
                timeout=TIMEOUT_S))
        assert _dev(out, _oracle(sess, toks)) < KV_BOUND, \
            "int8 KV pages drifted past the accuracy bound"
        assert tq.counters()["kv_pages_quantized"] > 0
    finally:
        _close(*stack)


def test_page16_export_restores_into_page64_int8():
    """Twin of ``test_fleet_migration_page16_restores_into_page64_int8``
    (``tests/test_paged_decode.py``): the payload is dense rows, the int8
    destination quantizes on restore."""
    import pickle

    net = _decoder(64, 23)
    toks = _toks(47, 12)
    src = _stack(net, 16)
    try:
        for x in toks[:6]:
            src[2].submit(x, session_id="u").result(timeout=TIMEOUT_S)
        wire = pickle.dumps(src[0].export_state())
    finally:
        _close(*src)
    rows = pickle.loads(wire)["sessions"]["u"]["states"]
    dst = _stack(net, 64, kv_int8=True)
    try:
        tq.reset_counters()
        assert dst[0].restore_state(pickle.loads(wire)) == 1
        assert tq.counters()["kv_pages_quantized"] > 0
        for got, want, paged in zip(dst[0].read("u"), rows,
                                    net.state_row_pageable()):
            if paged:
                assert _dev(got, want) < KV_BOUND
            else:
                onp.testing.assert_array_equal(got, want)
        for x in toks[6:]:
            out = onp.asarray(dst[2].submit(x, session_id="u").result(
                timeout=TIMEOUT_S))
        assert _dev(out, _oracle(dst[1], toks)) < KV_BOUND, \
            "int8 destination drifted past the KV accuracy bound"
    finally:
        _close(*dst)
