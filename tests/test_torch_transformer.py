"""TransformerLM: the port's training path against the JAX package's.

``TransformerLM(vocab 40, E 32, 2 layers, 4 heads, max_len 32)``, with
and without tied embedding, built in JAX (Xavier init, explicit prefix)
and carried into the port by ``convert.params_from_numpy``. Tokens are
made with numpy from a seed. On the CPU the port's attention is K1's
plain version with the recompute backward; the JAX side runs its XLA
reference path.

Tolerances:

- logits, the loss and every parameter's gradient: rtol = atol = 1e-4,
  the bound ``tests/test_torch_decoder.py`` states: torch and XLA sum
  each matmul in a different order, and the differences pass through
  two layers and a vocabulary head (the tied embedding's gradient is the
  sum of the lookup's and the head's);
- losses over several ``Trainer`` steps: rtol 1e-3;
- parameters after the steps: atol 1e-5 for SGD with momentum (a linear
  update of gradients that agree within 1e-4 of their scale), and
  ``2 * lr * steps`` for Adam, whose ``m / sqrt(v)`` turns an ulp-level
  difference in a near-zero gradient into a step of up to ``lr`` either
  way; every other parameter entry is held to 1e-4.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models import TransformerLM as JaxTransformerLM

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd
from mxnet_tpu_torch.models import TransformerLM

TOL = 1e-4
CFG = dict(vocab_size=40, embed_dim=32, num_layers=2, num_heads=4,
           max_len=32)
B, S = 4, 12


def _tokens(seed=0):
    return onp.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (B, S)).astype("f")


def _pair(tie, seed=0):
    """The JAX model (Xavier-initialized) and the port's, holding the
    same weights."""
    jmx.random.seed(seed)
    jnet = JaxTransformerLM(**CFG, tie_weights=tie,
                            prefix=f"torchparity_lm{int(tie)}_")
    jnet.initialize(jmx.init.Xavier())
    with jautograd.pause():
        jnet(jmx.nd.array(_tokens()))  # finishes the deferred shapes
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet = convert.params_from_numpy(TransformerLM(**CFG, tie_weights=tie),
                                     arrays, ctx=mx.cpu())
    return jnet, tnet


def _loss_jax(jnet, toks):
    logits = jnet(jmx.nd.array(toks))
    return jgluon.loss.SoftmaxCrossEntropyLoss()(
        logits[:, :-1].reshape(B * (S - 1), CFG["vocab_size"]),
        jmx.nd.array(toks)[:, 1:].reshape(B * (S - 1))).mean()


def _loss_port(tnet, toks):
    logits = tnet(nd.array(toks, ctx=mx.cpu()))
    return gluon.loss.SoftmaxCrossEntropyLoss()(
        logits[:, :-1].reshape(B * (S - 1), CFG["vocab_size"]),
        nd.array(toks, ctx=mx.cpu())[:, 1:].reshape(B * (S - 1))).mean()


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_logits_match_jax(tie):
    jnet, tnet = _pair(tie)
    toks = _tokens(1)
    with jautograd.pause():
        want = jnet(jmx.nd.array(toks)).asnumpy()
    got = tnet(nd.array(toks, ctx=mx.cpu()))
    assert got.shape == (B, S, CFG["vocab_size"])
    assert got.data.grad_fn is None  # no graph outside record()
    onp.testing.assert_allclose(got.asnumpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_loss_and_every_gradient_match_jax(tie):
    jnet, tnet = _pair(tie)
    toks = _tokens(2)
    with jautograd.record():
        jloss = _loss_jax(jnet, toks)
    jloss.backward()
    with autograd.record():
        tloss = _loss_port(tnet, toks)
    tloss.backward()
    onp.testing.assert_allclose(tloss.asscalar(), jloss.asscalar(),
                                rtol=TOL, atol=TOL)
    jparams = jnet._collect_params_with_prefix()
    tparams = tnet._collect_params_with_prefix()
    assert sorted(jparams) == sorted(tparams)
    assert ("head.weight" in tparams) == (not tie)
    for name, p in tparams.items():
        got, want = p.grad().asnumpy(), jparams[name].grad().asnumpy()
        assert onp.abs(want).max() > 0, name
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                    err_msg=name)


@pytest.mark.parametrize("optimizer,params,steps", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 3),
    ("adam", {"learning_rate": 1e-3}, 5),
], ids=["sgd-momentum", "adam"])
def test_trainer_steps_track_jax(optimizer, params, steps):
    jnet, tnet = _pair(True)
    jtr = jgluon.Trainer(jnet.collect_params(), optimizer, dict(params))
    ttr = gluon.Trainer(tnet.collect_params(), optimizer, dict(params))
    toks = _tokens(3)
    losses = []
    for _ in range(steps):
        with jautograd.record():
            jloss = _loss_jax(jnet, toks)
        jloss.backward()
        jtr.step(B)
        with autograd.record():
            tloss = _loss_port(tnet, toks)
        tloss.backward()
        ttr.step(B)
        losses.append((float(jloss.asscalar()), float(tloss.asscalar())))
    jl, tl = map(onp.array, zip(*losses))
    onp.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    lr = params["learning_rate"]
    jparams = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        got, want = p.data().asnumpy(), jparams[name].data().asnumpy()
        diff = onp.abs(got - want)
        if optimizer == "sgd":
            assert diff.max() < 1e-5, (name, diff.max())
        else:
            assert diff.max() <= 2 * lr * steps, (name, diff.max())
            assert (diff > TOL).mean() < 0.01, (name, (diff > TOL).mean())


def test_transformer_lm_trains():
    """Port of ``test_transformer_lm_trains`` (tests/test_attention.py:
    104-127): the loss falls over 10 Adam steps."""
    mx.random.seed(0)
    with mx.cpu():
        net = TransformerLM(vocab_size=40, embed_dim=32, num_layers=1,
                            num_heads=4, max_len=32, tie_weights=True)
        net.initialize(mx.init.Xavier())
        toks = nd.array(onp.random.RandomState(0).randint(0, 40, (4, 12))
                        .astype("f"))
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    first = None
    for _ in range(10):
        with autograd.record():
            logits = net(toks)
            loss = lf(logits[:, :-1].reshape(4 * 11, 40),
                      toks[:, 1:].reshape(4 * 11)).mean()
        loss.backward()
        tr.step(4)
        first = first if first is not None else float(loss.asscalar())
    assert float(loss.asscalar()) < first
    net.hybridize()
    assert net(toks).shape == (4, 12, 40)


def test_sequence_parallel_options_raise():
    with pytest.raises(mx.MXNetError, match="multi-device"):
        TransformerLM(**CFG, ring_axis="sp")
