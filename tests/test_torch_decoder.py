"""DecoderBlockLM: the PyTorch port's decode step against the JAX
block, with the JAX block's weights carried across.

Three streams step 12 times with explicit states on both sides; logits
and every KV cache are compared after each step. Tolerance
``atol = rtol = 1e-4``: torch and XLA sum each matmul in a different
order, and the differences pass through two layers and a vocabulary
head. The JAX serving stack is not the oracle here (its stateful tests
fail on this container); the JAX block's own explicit-state loop is.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.models import DecoderBlockLM as JaxDecoderBlockLM

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import DecoderBlockLM

TOL = 1e-4
VOCAB, EMBED, LAYERS, HEADS, MAXLEN = 32, 16, 2, 2, 16


def _jax_block(impl):
    jmx.random.seed(21)
    net = JaxDecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                            num_heads=HEADS, max_len=MAXLEN, impl=impl,
                            prefix="decoder_")  # leaves the name counters
    net.initialize()
    with jautograd.pause(train_mode=False):
        net(jmx.nd.zeros((1, 1), dtype="int32"), *_jax_states(net, 1))
    return net


def _jax_states(net, batch, rows=None):
    rows = rows or [onp.zeros((batch,) + s, dt) for s, dt in
                    zip(net.state_row_shapes(), net.state_row_dtypes())]
    return [jmx.nd.array(r, dtype=r.dtype) for r in rows]


def _port_block(jnet, impl=None):
    net = DecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                         num_heads=HEADS, max_len=MAXLEN, impl=impl)
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    return convert.params_from_numpy(net, arrays, ctx=mx.cpu())


def _port_states(rows):
    return [mx.nd.array(r, ctx=mx.cpu(), dtype=r.dtype) for r in rows]


def _run_both(jnet, tnet, tokens, rows):
    """Step both blocks over ``tokens`` from state ``rows``; yields
    (jax outputs, port outputs) as numpy lists after every step."""
    jst, tst = _jax_states(jnet, None, rows), _port_states(rows)
    for tok in tokens:
        with jautograd.pause(train_mode=False):
            jo = jnet(jmx.nd.array(tok), *jst)
        with mx.autograd.pause():
            to = tnet(mx.nd.array(tok, ctx=mx.cpu()), *tst)
        jst, tst = list(jo[1:]), list(to[1:])
        yield [o.asnumpy() for o in jo], [o.asnumpy() for o in to]


def _zero_rows(batch):
    net = DecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                         num_heads=HEADS, max_len=MAXLEN)
    return [onp.zeros((batch,) + s, dt) for s, dt in
            zip(net.state_row_shapes(), net.state_row_dtypes())]


def test_state_protocol_matches_jax():
    jnet = _jax_block("lax")
    tnet = _port_block(jnet)
    assert tnet.state_row_shapes() == jnet.state_row_shapes()
    assert tnet.state_row_dtypes() == jnet.state_row_dtypes()
    assert tnet.state_row_pageable() == jnet.state_row_pageable()
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())


@pytest.mark.parametrize("jax_impl", ["lax", "interpret"])
@pytest.mark.parametrize("port_impl", [None, "cuda"])
def test_decode_steps_match_jax(jax_impl, port_impl):
    """12 steps on 3 streams. ``port_impl="cuda"`` on CPU tensors takes
    the kernel's plain version: the path is the same as on the card up
    to the wrapper."""
    jnet = _jax_block(jax_impl)
    tnet = _port_block(jnet, impl=port_impl)
    rs = onp.random.RandomState(0)
    tokens = [rs.randint(0, VOCAB, size=(3, 1)).astype("int32")
              for _ in range(12)]
    for step, (jo, to) in enumerate(_run_both(jnet, tnet, tokens,
                                              _zero_rows(3))):
        assert len(to) == len(jo) == 2 + 2 * LAYERS
        assert to[0].shape == (3, VOCAB)
        for j, t in zip(jo[:-1], to[:-1]):  # logits and caches
            onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
        onp.testing.assert_array_equal(to[-1], jo[-1])  # pos + 1
        assert (to[-1] == step + 1).all()


def test_decode_at_and_past_max_len_matches_jax():
    """A step at ``pos = max_len - 1`` fills the last cache slot; the
    step after it (``pos = max_len``) has no slot and no position
    embedding: the JAX block drops the cache write and reads a NaN
    position row, and the port does the same instead of raising."""
    jnet = _jax_block("lax")
    tnet = _port_block(jnet)
    rs = onp.random.RandomState(3)
    rows = [rs.randn(*r.shape).astype(r.dtype) for r in _zero_rows(2)]
    rows[-1] = onp.full((2, 1), MAXLEN - 1, "int32")
    tokens = [onp.array([[1], [2]], "int32"), onp.array([[3], [4]], "int32")]
    results = list(_run_both(jnet, tnet, tokens, rows))
    (jo0, to0), (jo1, to1) = results
    for j, t in zip(jo0, to0):
        onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    assert onp.isfinite(to0[0]).all()
    assert onp.isnan(jo1[0]).all() and onp.isnan(to1[0]).all()
    # the past-the-end write is dropped on both sides
    for j, t, prev in zip(jo1[1:-1], to1[1:-1], to0[1:-1]):
        onp.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
        onp.testing.assert_array_equal(t, prev)
