"""``gluon.contrib.cnn.DeformableConvolution`` in the PyTorch port against
the JAX package's layer, on the CPU.

The JAX layer is built and initialized, its offset convolution given
random weights and a bias off the integers (zero-initialized offsets
would sample exactly on the grid, where the bilinear weight has a kink),
and its parameters carried into the port's layer by name with
``convert.params_from_numpy``. Forward outputs and the gradients of a
random cotangent to the data, the deformable weight and bias, and the
offset convolution's weight and bias (through which the offsets' own
gradient flows) agree within 1e-5 of each tensor's largest magnitude;
the port's hybridized layer gives the eager layer's outputs.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.contrib import cnn as jcnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, nd
from mxnet_tpu_torch.gluon.contrib import cnn

CPU = mx.cpu()
TOL = 1e-5


def _close(got, want, what):
    scale = float(onp.abs(want).max())
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                                err_msg=what)


def _layers(kw, x_shape, seed):
    rs = onp.random.RandomState(seed)
    jnet = jcnn.DeformableConvolution(**kw)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(onp.zeros(x_shape, "f")))
    params = jnet._collect_params_with_prefix()
    for name, p in params.items():
        shape = p.data().shape
        if name.startswith("offset"):
            v = rs.uniform(-0.3, 0.3, shape) + (0.37 if name.endswith(
                "bias") else 0.0)
            p.set_data(jmx.nd.array(v.astype("f")))
        elif name == "bias":
            p.set_data(jmx.nd.array(rs.uniform(-0.5, 0.5, shape)
                                    .astype("f")))
    arrays = {k: p.data().asnumpy() for k, p in params.items()}
    tnet = cnn.DeformableConvolution(**kw)
    convert.params_from_numpy(tnet, arrays, ctx=CPU)
    return jnet, tnet, rs


def _record(pkg, net, x, ct):
    def arr(a):
        return pkg.nd.array(a) if pkg is jmx else nd.array(a, ctx=CPU)

    xa = arr(x)
    xa.attach_grad()
    with pkg.autograd.record():
        y = net(xa)
        loss = (y * arr(ct)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()}
    return y.asnumpy(), xa.grad.asnumpy(), grads


@pytest.mark.parametrize("kw,x_shape", [
    (dict(channels=6, kernel_size=3, padding=1, groups=2,
          num_deformable_group=2, activation="relu"), (2, 4, 7, 8)),
    (dict(channels=4, kernel_size=(3, 3), strides=2, padding=2, dilation=2,
          use_bias=False), (1, 3, 9, 9)),
], ids=["grouped_relu", "strided_dilated_no_bias"])
def test_deformable_layer_forward_and_gradients_match_jax(kw, x_shape):
    jnet, tnet, rs = _layers(kw, x_shape, seed=3)
    x = rs.uniform(-1, 1, x_shape).astype("f")
    y_shape = tnet(nd.array(x, ctx=CPU)).shape
    ct = rs.standard_normal(y_shape).astype("f")
    jy, jgx, jg = _record(jmx, jnet, x, ct)
    ty, tgx, tg = _record(mx, tnet, x, ct)
    _close(ty, jy, "output")
    _close(tgx, jgx, "data gradient")
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k], jg[k], f"{k} gradient")
    tnet.hybridize()
    with autograd.pause():
        _close(tnet(nd.array(x, ctx=CPU)).asnumpy(), jy, "hybridized")


def test_offsets_start_on_the_grid():
    """Zero-initialized offsets: the layer is the plain convolution."""
    net = cnn.DeformableConvolution(5, kernel_size=3, padding=1,
                                    in_channels=3)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = nd.array(onp.random.RandomState(0).uniform(-1, 1, (2, 3, 6, 6))
                 .astype("f"), ctx=CPU)
    want = nd.convolution(x, net.weight.data(), net.bias.data(),
                          kernel=(3, 3), pad=(1, 1), num_filter=5)
    _close(net(x).asnumpy(), want.asnumpy(), "grid")
    assert net.offset_weight.data().shape == (18, 3, 3, 3)
