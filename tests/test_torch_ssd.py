"""SSD through the PyTorch port against the JAX package, on the CPU.

- The toy twin (``mxnet_tpu_torch/examples/train_ssd_toy.py``) against
  the JAX example's ``ToySSD`` (``examples/train_ssd_toy.py``): the same
  weights carried across, the same seeded batches; the losses and every
  gradient of the first step, and the weights after three Adam steps,
  within rtol 1e-4 (gradients and weights: 1e-4 of each tensor's largest
  value as well).
- SSD300-VGG16 (``tools/profile_ssd.py``'s ``build_ssd300``, the one
  definition both packages build) with every width divided by 16, at
  300 x 300 so that the 8732-anchor layout is exercised, batch 2, two
  SGD steps: the anchors (1e-6), the class and location outputs, the
  loss, every gradient and the weights after the two steps within rtol
  1e-4 (and 1e-4 of each tensor's largest value), ``MultiBoxTarget``'s
  class targets and mask exact. The JAX network runs hybridized (one
  compiled program), the port's eagerly.
"""
import importlib.util
import os

import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.examples import train_ssd_toy as twin
from mxnet_tpu_torch.tools import profile_ssd as ps

CPU = mx.cpu()
RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_toy():
    path = os.path.join(ROOT, "examples", "train_ssd_toy.py")
    spec = importlib.util.spec_from_file_location("jax_train_ssd_toy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(net):
    return {k: onp.array(p.data().asnumpy())
            for k, p in net._collect_params_with_prefix().items()}


def _grads(net):
    return {k: onp.array(p.grad().asnumpy())
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _close(got, want, what, rtol=RTOL):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(onp.abs(want).max()) if want.size else 1.0
    onp.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                                err_msg=what)


# -- the toy twin ---------------------------------------------------------

def test_toy_twin_matches_the_jax_example_losses_gradients_and_adam():
    jtoy = _jax_toy()
    A = len(twin.SIZES) + len(twin.RATIOS) - 1
    assert (jtoy.IMG, jtoy.CLASSES) == (twin.IMG, twin.CLASSES)
    rng = onp.random.RandomState(0)
    batches = [twin.synth_batch(rng, 16) for _ in range(3)]
    jmx.random.seed(0)
    jnet = jtoy.ToySSD(A)
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        jnet(jmx.nd.array(batches[0][0]))
    tnet = convert.params_from_numpy(twin.toy_ssd(A), _host(jnet), ctx=CPU)
    runs = {}
    for pkg, net, ctx in ((jmx, jnet, None), (mx, tnet, CPU)):
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 2e-3})
        ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        anchors, losses, grads = None, [], None
        for x, labels in batches:
            loss, anchors = twin.losses(
                pkg, net, ce, pkg.nd.array(x, ctx=ctx),
                pkg.nd.array(labels, ctx=ctx), anchors)
            loss.backward()
            grads = grads or _grads(net)
            trainer.step(16)
            losses.append(float(loss.asscalar()))
        runs[pkg] = (losses, grads, _host(net), anchors.asnumpy())
    (tl, tg, tw, ta), (jl, jg, jw, ja) = runs[mx], runs[jmx]
    _close(ta, ja, "anchors")
    onp.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tg.keys() == jg.keys()
    for k in jg:
        _close(tg[k], jg[k], f"grad {k}")
    for k in jw:
        _close(tw[k], jw[k], f"weight {k} after 3 Adam steps")


# -- SSD300-VGG16 at small widths -----------------------------------------

def test_ssd300_small_widths_matches_jax_two_sgd_steps():
    jnet = ps.build(jmx, None, div=16)
    jnet.hybridize()
    tnet = convert.params_from_numpy(ps.build_ssd300(mx, div=16),
                                     _host(jnet), ctx=CPU)
    assert ps.trainable_count(tnet) == ps.trainable_count(jnet)
    xs, ys = ps.synthetic_batch(2)
    runs = {}
    for pkg, net, ctx in ((jmx, jnet, None), (mx, tnet, CPU)):
        anchor = ps.anchors(pkg, ctx)
        trainer = ps.make_trainer(pkg, net)
        x, y = pkg.nd.array(xs, ctx=ctx), pkg.nd.array(ys, ctx=ctx)
        record = {"anchors": anchor.asnumpy(), "losses": []}
        for step in range(2):
            with pkg.autograd.record():
                cls_preds, loc_preds = net(x)
                tgt = ps.targets(pkg, anchor, y, cls_preds)
                loss = ps.ssd_loss(pkg, cls_preds, loc_preds, *tgt)
            loss.backward()
            if step == 0:
                record["outputs"] = (cls_preds.asnumpy(),
                                     loc_preds.asnumpy())
                record["targets"] = [t.asnumpy() for t in tgt]
                record["grads"] = _grads(net)
            trainer.step(1)
            record["losses"].append(float(loss.asscalar()))
        record["weights"] = _host(net)
        runs[pkg] = record
    t, j = runs[mx], runs[jmx]
    assert t["anchors"].shape == (1, ps.ANCHORS, 4)
    onp.testing.assert_allclose(t["anchors"], j["anchors"], rtol=1e-6,
                                atol=1e-6)
    _close(t["outputs"][0], j["outputs"][0], "class outputs")
    _close(t["outputs"][1], j["outputs"][1], "location outputs")
    assert t["outputs"][0].shape == (2, ps.ANCHORS, ps.CLASSES + 1)
    for name, g, w in zip(("loc_t", "loc_mask", "cls_t"), t["targets"],
                          j["targets"]):
        if name == "loc_t":
            _close(g, w, name, rtol=1e-6)
        else:
            onp.testing.assert_array_equal(g, w, err_msg=name)
    assert (j["targets"][2] == -1).any() and (j["targets"][2] > 0).any()
    onp.testing.assert_allclose(t["losses"], j["losses"], rtol=RTOL)
    assert j["grads"].keys() == t["grads"].keys()
    for k in j["grads"]:
        _close(t["grads"][k], j["grads"][k], f"grad {k}")
    for k in j["weights"]:
        _close(t["weights"][k], j["weights"][k], f"weight {k}")


@pytest.mark.parametrize("div", [1, 16])
def test_ssd300_structure(div):
    """Anchors per position 4, 6, 6, 6, 4, 4 (8732 in all), 21 classes;
    at published widths 26,285,486 trainable parameters."""
    assert ps.anchors_per_position() == [4, 6, 6, 6, 4, 4]
    assert sum(f * f * a for f, a in zip(ps.FEATURE_SIZES,
                                         ps.anchors_per_position())) \
        == ps.ANCHORS == 8732
    net = ps.build_ssd300(mx, div=div)
    net.initialize(ps.initializer(mx), ctx=CPU)
    with mx.autograd.pause():
        cls_preds, loc_preds = net(mx.nd.zeros((1, 3, 300, 300), ctx=CPU))
    assert cls_preds.shape == (1, 8732, 21)
    assert loc_preds.shape == (1, 8732 * 4)
    if div == 1:
        assert ps.trainable_count(net) == 26285486
    scale = net.scale.data().asnumpy()
    assert scale.shape == (1, 512 // div, 1, 1) and (scale == 20).all()
