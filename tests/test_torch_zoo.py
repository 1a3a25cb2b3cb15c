"""The vision model zoo of the PyTorch port against the JAX package's, on
the CPU: ResNet V2, AlexNet, VGG (with and without batch norm),
SqueezeNet 1.0 and 1.1, MobileNet v1 and v2, DenseNet and Inception v3,
and the registry.

For each family the port's model is built and initialized (Xavier, then
random biases, norm parameters and running statistics), and its weights
and running statistics are carried into the JAX model (explicit prefix)
by structural name: every name and shape must match. Inputs are drawn with numpy from a seed; each
model runs one eval-mode forward and the gradient of ``sum(logits *
cotangent)`` with respect to the input and every parameter, in both
packages. Widths are cut (``classes=10``, the smallest multiplier) and
inputs are the smallest each network accepts (224 x 224 for SqueezeNet,
whose classifier pools 13 x 13; 299 x 299 for Inception v3).

Tolerances: logits and gradients within 1e-3 of each compared tensor's
largest magnitude (torch's and XLA's convolutions sum in other orders
through up to 121 layers). Max-pools over ReLU outputs meet near-ties:
two values of one window within float32 rounding of each other (0.18193930
and 0.18193932 in SqueezeNet 1.0's last pool), where the rounding of
each package's forward decides which element takes the window's
gradient, and everything behind it follows. A gradient off by more than
the bound is then held, with the JAX package's, to the port's float64
run of the same weights: the port's relative L2 distance must be within
1e-3 or within 4 times the JAX package's own (SqueezeNet 1.0's input
gradient: 0.97% against 0.49%; Inception v3's: 0.060% against
0.00007%). The space-to-depth stem against the plain 7x7/2 stem, and
NHWC against NCHW: within 1e-5 of the largest magnitude (the same sums
in another order).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, nd
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
NET_TOL = 1e-3
TOL = 1e-5
# a gradient through a max-pool near-tie, against float64: the port's
# relative L2 distance within this many times the JAX package's
NEAR_TIE_FACTOR = 4

# model -> (input size, constructor kwargs)
FAMILIES = {
    "resnet18_v2": (32, {}),
    "resnet50_v2": (32, {}),
    "alexnet": (67, {}),
    "vgg11": (32, {}),
    "vgg11_bn": (32, {}),
    "squeezenet1_0": (224, {}),
    "squeezenet1_1": (224, {}),
    "mobilenet0_25": (32, {}),
    "mobilenet_v2_0_25": (32, {}),
    "densenet121": (32, {}),
    "inception_v3": (299, {}),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two threads for the port's CPU convolutions, so this file leaves
    the other workers of a parallel run their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol, what=""):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(onp.max(onp.abs(want))) if want.size else 1.0
    onp.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                err_msg=what)


def _host(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _grad_run(net, x, cot, pkg_nd, pkg_autograd, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    xin = pkg_nd.array(x, **kw)
    xin.attach_grad()
    with pkg_autograd.record(train_mode=False):
        out = net(xin)
        loss = (out * pkg_nd.array(cot, **kw)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in
             net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xin.grad.asnumpy(), grads


def _randomize_affine(net, rs):
    """Random biases, norm parameters and running statistics: no ReLU
    input sits exactly at 0, where the JAX package's ReLU gradient is
    0.5 and the reference's (and the port's) is 0 (ROADMAP C)."""
    ranges = {"bias": (-0.2, 0.2), "beta": (-0.2, 0.2), "gamma": (0.5, 1.5),
              "running_mean": (-0.1, 0.1), "running_var": (0.5, 1.5)}
    for k, p in sorted(net._collect_params_with_prefix().items()):
        kind = k.rsplit(".", 1)[-1]
        if kind in ranges:
            lo, hi = ranges[kind]
            p.set_data(rs.uniform(lo, hi, p.shape).astype("float32"))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_zoo_model_matches_jax(name):
    """The port builds and initializes the model (its first forward
    finishes the deferred shapes); the weights go into the JAX model's
    parameters (``_load_init_from``, no forward needed), whose names and
    shapes must be the port's; the JAX model runs hybridized."""
    size, kw = FAMILIES[name]
    mx.random.seed(0)
    rs = onp.random.RandomState(0)
    x = rs.randn(1, 3, size, size).astype("float32")
    tnet = vision.get_model(name, classes=10, **kw)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    _randomize_affine(tnet, rs)
    jnet = jvision.get_model(name, classes=10, prefix="j_", **kw)
    jp, tp = jnet._collect_params_with_prefix(), \
        tnet._collect_params_with_prefix()
    assert sorted(tp) == sorted(jp)
    for k, v in _host(tnet).items():
        jp[k]._load_init_from(jnd.array(v))
        assert tuple(jp[k].shape) == v.shape, k
    jnet.hybridize()
    cot = rs.randn(1, 10).astype("float32")
    jout, jgx, jg = _grad_run(jnet, x, cot, jnd, jautograd)
    tout, tgx, tg = _grad_run(tnet, x, cot, nd, autograd, ctx=CPU)
    _close(tout, jout, NET_TOL, "logits")
    assert sorted(tg) == sorted(jg)
    tg["input"], jg["input"] = tgx, jgx
    off = [k for k in sorted(tg) if onp.abs(tg[k] - jg[k]).max() >
           NET_TOL * onp.abs(jg[k]).max()]
    if off:
        # max-pool near-ties: hold both to the port's float64 run
        tnet.cast("float64")
        _, gx64, g64 = _grad_run(tnet, x.astype("float64"),
                                 cot.astype("float64"), nd, autograd,
                                 ctx=CPU)
        g64["input"] = gx64
        for k in off:
            want = g64[k]
            port, ref = _l2(tg[k], want), _l2(jg[k], want)
            assert port <= max(NET_TOL, NEAR_TIE_FACTOR * ref), \
                (k, port, ref)


def _l2(a, b):
    return float(onp.linalg.norm((a - b).ravel()) /
                 onp.linalg.norm(b.ravel()))


def test_get_model_lists_the_jax_names():
    assert sorted(vision._models) == sorted(jvision._models)
    for name in sorted(vision._models):
        assert type(vision.get_model(name)).__name__ == \
            type(jvision.get_model(name)).__name__, name
    with pytest.raises(ValueError, match="not supported"):
        vision.get_model("vgg17")


@pytest.mark.parametrize("name", ["resnet50_v2", "alexnet", "vgg16",
                                  "vgg16_bn", "squeezenet1_1",
                                  "mobilenet1_0", "mobilenet_v2_1_0",
                                  "densenet121", "inception_v3"])
def test_pretrained_names_the_model_store_slice(name):
    with pytest.raises(mx.MXNetError, match="slice 11"):
        vision.get_model(name, pretrained=True)


@pytest.mark.parametrize("size", [32, 33, 35])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_s2d_stem_equals_the_plain_stem(size, layout):
    """``stem_s2d=True`` computes the 7x7/2 stem as a 4x4/1 convolution
    over a space-to-depth input: the same parameter and the same output,
    at even and odd sizes, through the whole network (ResNet V1 and V2)."""
    mx.random.seed(1)
    rs = onp.random.RandomState(1)
    shape = (2, 3, size, size) if layout == "NCHW" else (2, size, size, 3)
    x = nd.array(rs.randn(*shape).astype("float32"), ctx=CPU)
    for ctor in (vision.resnet18_v1, vision.resnet18_v2):
        plain = ctor(classes=10, layout=layout)
        s2d = ctor(classes=10, layout=layout, stem_s2d=True)
        plain.initialize(mx.init.Xavier(), ctx=CPU)
        want = plain(x).asnumpy()
        convert.params_from_numpy(s2d, _host(plain), ctx=CPU)
        stem = 0 if ctor is vision.resnet18_v1 else 1
        assert type(s2d.features[stem]).__name__ == "_S2DStemConv"
        _close(s2d.features[stem](x).asnumpy(),
               plain.features[stem](x).asnumpy(), TOL, "stem")
        _close(s2d(x).asnumpy(), want, TOL, "network")


def test_s2d_stem_network_matches_jax_plain_stem():
    """The port's s2d ResNet-50 V2 against the JAX package's plain one,
    with the same weights."""
    mx.random.seed(2)
    rs = onp.random.RandomState(2)
    x = rs.randn(1, 3, 64, 64).astype("float32")
    tnet = vision.resnet50_v2(classes=10, stem_s2d=True)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    got = tnet(nd.array(x, ctx=CPU)).asnumpy()
    jnet = jvision.resnet50_v2(classes=10, prefix="js_")
    jp = jnet._collect_params_with_prefix()
    for k, v in _host(tnet).items():
        jp[k]._load_init_from(jnd.array(v))
    jnet.hybridize()
    _close(got, jnet(jnd.array(x)).asnumpy(), NET_TOL, "logits")


def _to_nhwc(arrays, ref_net):
    """NCHW weights in the NHWC layout: convolution filters (O, I, kh,
    kw) become (O, kh, kw, I); everything else is layout-free."""
    out = {}
    for k, v in arrays.items():
        out[k] = v.transpose(0, 2, 3, 1) if v.ndim == 4 else v
    return out


@pytest.mark.parametrize("name", ["mobilenet0_25", "mobilenet_v2_0_25",
                                  "resnet18_v2", "resnet50_v2"])
def test_nhwc_equals_nchw(name):
    mx.random.seed(3)
    rs = onp.random.RandomState(3)
    x = rs.randn(2, 3, 32, 32).astype("float32")
    a = vision.get_model(name, classes=10)
    a.initialize(mx.init.Xavier(), ctx=CPU)
    want = a(nd.array(x, ctx=CPU)).asnumpy()
    b = vision.get_model(name, classes=10, layout="NHWC")
    convert.params_from_numpy(b, _to_nhwc(_host(a), a), ctx=CPU)
    got = b(nd.array(x.transpose(0, 2, 3, 1).copy(), ctx=CPU)).asnumpy()
    _close(got, want, TOL, name)


def test_vgg16_counts_the_jax_models_parameters():
    """VGG-16 at 1000 classes and 224 x 224: 13 convolutions and 3 FC
    layers, 138,357,544 trainable parameters in both packages (the count
    the card's training phase checks)."""
    x = onp.zeros((1, 3, 224, 224), "float32")
    t = vision.vgg16()
    t.initialize(ctx=CPU)
    t(nd.array(x, ctx=CPU))
    j = jvision.vgg16(prefix="jv_")
    j.initialize()
    j(jnd.array(x))

    def count(net):
        return sum(int(onp.prod(p.shape)) for p in
                   net.collect_params().values() if p.grad_req != "null")

    assert count(t) == count(j) == 138_357_544
    convs = [k for k in t._collect_params_with_prefix()
             if k.endswith("weight") and len(
                 t._collect_params_with_prefix()[k].shape) == 4]
    assert len(convs) == 13
    assert [b._rate for b in t.features._children.values()
            if isinstance(b, mx.gluon.nn.Dropout)] == [0.5, 0.5]


def test_zoo_precision_tool_walks_every_layer_on_the_cpu():
    """``tools/zoo_precision.py``'s per-layer walk on the CPU: float32
    against float64 for every layer of ResNet-18 v2 at 32 x 32, each
    output and each gradient close (no max-pool near-tie at this size)."""
    from mxnet_tpu_torch.tools.zoo_precision import _rel, layer_gradients

    mx.random.seed(4)
    net = vision.resnet18_v2(classes=10)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    rs = onp.random.RandomState(4)
    x = rs.randn(2, 3, 32, 32).astype("float32")
    net(nd.array(x, ctx=CPU))
    cot = rs.randn(2, 10).astype("float32")
    arrays = _host(net)
    names, g64, o64 = layer_gradients("resnet18_v2", arrays, x, cot, CPU,
                                      "float64")
    _, g32, o32 = layer_gradients("resnet18_v2", arrays, x, cot, CPU,
                                  "float32")
    assert len(names) == len(net.features) == len(g64) == len(o32)
    assert all(_rel(a, b) < 1e-4 for a, b in zip(g32, g64))
    assert all(_rel(a, b) < 1e-5 for a, b in zip(o32, o64))
