"""The batcher's session-state checkpoint in the port, on the CPU.

A stateful ``DynamicBatcher`` given ``state_checkpoint=`` (a
``CheckpointManager`` over the session's store) runs every accepted step
at ``close()`` and then checkpoints the live sessions. Here two streams
of a small ``DecoderBlockLM`` are closed mid-page on a store of 4-token
pages and restored into a fresh session over 8-token pages and over row
slots. The continued streams must be bitwise the port's own uninterrupted
explicit-state loop (``sess.step``), the serving oracle of
``test_torch_serving_paged.py``: with one bucket every step runs the same
matmul shapes. Against the JAX block's explicit-state loop, with its
weights carried across, the logits agree within 1e-5.
"""
import logging

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.models import DecoderBlockLM as JaxDecoderBlockLM

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import DecoderBlockLM
from mxnet_tpu_torch.resilience import CheckpointManager, faults

VOCAB, EMBED, LAYERS, HEADS, MAXLEN = 32, 16, 2, 2, 16
BUCKETS = [4]
BEFORE, AFTER = 6, 7  # tokens before the close (mid-page), after it
JAX_TOL = 1e-5
TIMEOUT_S = 60


@pytest.fixture(scope="module")
def nets():
    jmx.random.seed(25)
    jnet = JaxDecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                             num_heads=HEADS, max_len=MAXLEN,
                             prefix="decoder_")
    jnet.initialize()
    with jautograd.pause(train_mode=False):
        jnet(jmx.nd.zeros((1, 1), dtype="int32"),
             *[jmx.nd.array(r, dtype=r.dtype) for r in _zero_rows(jnet, 1)])
    net = DecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                         num_heads=HEADS, max_len=MAXLEN)
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    return jnet, convert.params_from_numpy(net, arrays, ctx=mx.cpu())


def _zero_rows(net, batch):
    return [onp.zeros((batch,) + s, dt) for s, dt in
            zip(net.state_row_shapes(), net.state_row_dtypes())]


@pytest.fixture
def stack(nets):
    made = []

    def build(page_tokens, checkpoint=None):
        net = nets[1]
        store = serving.SessionStateStore(
            net.state_row_shapes(), net.state_row_dtypes(), max_sessions=4,
            byte_budget=0, ttl_s=0, pageable=net.state_row_pageable(),
            page_tokens=page_tokens, ctx=mx.cpu())
        sess = serving.InferenceSession(
            net, input_shapes=[(1, 1)], input_dtypes=["int32"],
            state_store=store, buckets=BUCKETS, ctx=mx.cpu())
        mgr = None if checkpoint is None else CheckpointManager(
            checkpoint, session_state=store, async_mode=False)
        bat = serving.DynamicBatcher(sess, max_batch_size=max(BUCKETS),
                                     max_latency_ms=2.0,
                                     timeout_ms=TIMEOUT_S * 1e3,
                                     admission=False, state_checkpoint=mgr)
        made.append((store, sess, bat))
        return store, sess, bat, mgr

    yield build
    for store, sess, bat in made:
        bat.close()
        sess.close()
        store.close()


def _streams(seed):
    rs = onp.random.RandomState(seed)
    return {sid: [rs.randint(0, VOCAB, size=(1, 1)).astype("int32")
                  for _ in range(BEFORE + AFTER)] for sid in ("u", "v")}


def _serve(bat, streams, lo, hi):
    futs = {sid: [bat.submit(t, session_id=sid, slo_class="standard")
                  for t in toks[lo:hi]] for sid, toks in streams.items()}
    return {sid: [onp.asarray(f.result(timeout=TIMEOUT_S)) for f in fs]
            for sid, fs in futs.items()}


def _port_loop(sess, tokens):
    states = [onp.zeros((1,) + s, dt) for s, dt in
              zip(sess._block.state_row_shapes(),
                  sess._block.state_row_dtypes())]
    outs = []
    for tok in tokens:
        out, states = sess.step(tok, states=states)
        outs.append(out.asnumpy())
    return outs


def _jax_loop(jnet, tokens):
    st = [jmx.nd.array(r, dtype=r.dtype) for r in _zero_rows(jnet, 1)]
    outs = []
    for tok in tokens:
        with jautograd.pause(train_mode=False):
            o = jnet(jmx.nd.array(tok), *st)
        st = list(o[1:])
        outs.append(o[0].asnumpy())
    return outs


@pytest.mark.parametrize("page_tokens", [8, 0], ids=["pages8", "rows"])
def test_close_checkpoints_mid_page_and_streams_resume(tmp_path, stack,
                                                       nets, page_tokens):
    """Two streams closed after 6 tokens on 4-token pages (mid-page), the
    checkpoint written at close, a fresh session over ``page_tokens``
    restoring both: the 13 logits of each stream are bitwise the port's
    uninterrupted loop's, and within 1e-5 of the JAX block's."""
    streams = _streams(7)
    store1, sess1, bat1, mgr1 = stack(4, checkpoint=str(tmp_path))
    first = _serve(bat1, streams, 0, BEFORE)
    assert store1.stats()["pages_used"] == 2 * 2  # the second page half full
    bat1.close()
    assert mgr1.list_steps() == [store1.steps_total]
    serving.METRICS.reset()
    store2, sess2, bat2, mgr2 = stack(page_tokens)
    CheckpointManager(str(tmp_path), session_state=store2,
                      async_mode=False).restore()
    assert serving.METRICS.snapshot()["resumed_sessions"] == 2
    assert sorted(store2.live_sessions()) == ["u", "v"]
    rest = _serve(bat2, streams, BEFORE, BEFORE + AFTER)
    jnet, _ = nets
    for sid, toks in streams.items():
        got = first[sid] + rest[sid]
        want = _port_loop(sess2, toks)
        for g, w in zip(got, want):
            assert g.shape == (1, VOCAB)
            assert onp.array_equal(g, w)
        for g, j in zip(got, _jax_loop(jnet, toks)):
            onp.testing.assert_allclose(g, j, rtol=JAX_TOL, atol=JAX_TOL)
        assert store2.read(sid)[-1].item() == BEFORE + AFTER


def test_state_checkpoint_needs_a_stateful_session(tmp_path):
    from mxnet_tpu_torch.gluon import nn

    net = nn.Dense(4, in_units=3)
    net.initialize(ctx=mx.cpu())
    sess = serving.InferenceSession(net, input_shapes=[(1, 3)], buckets=[1],
                                    ctx=mx.cpu())
    mgr = CheckpointManager(str(tmp_path), async_mode=False)
    try:
        with pytest.raises(MXNetError, match="stateful"):
            serving.DynamicBatcher(sess, admission=False,
                                   state_checkpoint=mgr)
    finally:
        sess.close()


def test_a_failed_close_checkpoint_is_logged_and_close_completes(
        tmp_path, stack, caplog):
    streams = _streams(8)
    store, _, bat, mgr = stack(4, checkpoint=str(tmp_path))
    futs = _serve(bat, streams, 0, 2)
    with faults.inject("checkpoint_write", at=1), \
            caplog.at_level(logging.ERROR):
        bat.close()
    assert any("session-state checkpoint at close failed" in r.message
               for r in caplog.records)
    assert mgr.list_steps() == []
    assert all(len(v) == 2 for v in futs.values())
    assert sorted(store.live_sessions()) == ["u", "v"]
