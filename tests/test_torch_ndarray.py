"""NDArray, contexts, autograd scopes, random state and the op registry
of the PyTorch port, on the CPU.

Creation functions and NDArray arithmetic are held against the JAX
package bitwise: they are exact copies, index ranges and one fp32 add or
multiply per element, which both sides round alike.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ndarray import registry

CPU = mx.cpu()


@pytest.mark.parametrize("src", [
    [[1.5, -2.0], [3.25, 0.0]],                         # python floats
    onp.arange(6, dtype="float64").reshape(2, 3) / 7,  # float64
    onp.arange(6, dtype="int32").reshape(3, 2),
])
def test_array_dtype_and_values_match_jax(src):
    want = jmx.nd.array(src)
    got = mx.nd.array(src, ctx=CPU)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert onp.array_equal(got.asnumpy(), want.asnumpy())
    assert got.context == CPU


def test_creation_functions_match_jax():
    pairs = [
        (mx.nd.zeros((2, 3), ctx=CPU), jmx.nd.zeros((2, 3))),
        (mx.nd.zeros(4, ctx=CPU, dtype="int32"), jmx.nd.zeros(4, dtype="int32")),
        (mx.nd.arange(5, ctx=CPU), jmx.nd.arange(5)),
        (mx.nd.arange(2, 11, 3, ctx=CPU, dtype="int32"),
         jmx.nd.arange(2, 11, 3, dtype="int32")),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype
        assert onp.array_equal(got.asnumpy(), want.asnumpy())


def test_reshape_expand_dims_add_mul_match_jax():
    rs = onp.random.RandomState(4)
    a, b = rs.randn(2, 6).astype("f"), rs.randn(2, 6).astype("f")
    ta, tb = mx.nd.array(a, ctx=CPU), mx.nd.array(b, ctx=CPU)
    ja, jb = jmx.nd.array(a), jmx.nd.array(b)
    pairs = [
        (ta.reshape((3, 4)), ja.reshape((3, 4))),
        (ta.reshape(4, 3), ja.reshape(4, 3)),
        (mx.nd.expand_dims(ta, 1), jmx.nd.expand_dims(ja, axis=1)),
        (ta + tb, ja + jb), (ta * tb, ja * jb),
        (ta + 2.0, ja + 2.0), (3.0 * ta, 3.0 * ja),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert onp.array_equal(got.asnumpy(), want.asnumpy())


def test_asnumpy_is_a_copy_and_wait_to_read_returns():
    x = mx.nd.zeros((3,), ctx=CPU)
    host = x.asnumpy()
    x.data.add_(1.0)
    assert not host.any()
    x.wait_to_read()
    assert x.asnumpy().tolist() == [1.0, 1.0, 1.0]


def test_context_scope_sets_the_default_and_restores_it():
    assert mx.current_context() == mx.gpu(0)
    with CPU:
        assert mx.current_context() == CPU
        assert mx.nd.zeros((1,)).context == CPU
    assert mx.current_context() == mx.gpu(0)
    assert str(mx.gpu(1)) == "gpu(1)"
    assert mx.Context.from_device(torch.device("cpu")) == CPU
    with pytest.raises(mx.MXNetError, match="device type"):
        mx.Context("tpu")


def test_autograd_scopes_match_jax():
    jag, tag = jmx.autograd, mx.autograd
    for ag in (jag, tag):
        assert not ag.is_training()
        with ag.train_mode():
            assert ag.is_training()
            with ag.predict_mode():
                assert not ag.is_training()
            with ag.pause(train_mode=True):
                assert ag.is_training() and not ag.is_recording()
            assert ag.is_training()
        assert not ag.is_training()
    w = torch.ones(2, requires_grad=True)
    with tag.pause():
        assert not (w * 2).requires_grad
    assert (w * 2).requires_grad


def test_seed_makes_initialization_reproducible():
    def draw(seed):
        mx.random.seed(seed)
        net = mx.gluon.nn.Dense(4, in_units=3)
        net.initialize(ctx=CPU)
        return net.weight.data().asnumpy()

    first = draw(7)
    assert onp.array_equal(first, draw(7))
    assert not onp.array_equal(first, draw(8))
    assert onp.abs(first).max() <= 0.07  # Uniform(0.07), MXNet's default


def test_registry_dispatch_and_duplicate_names():
    op = registry.get_op("fully_connected")
    assert op is not None and "nd" in op.namespaces
    assert mx.nd.fully_connected.__name__ == "fully_connected"
    x = mx.nd.array(onp.ones((2, 3), "f"), ctx=CPU)
    w = mx.nd.array(onp.full((4, 3), 0.5, "f"), ctx=CPU)
    out = registry.invoke(op, (x, w), {"no_bias": True, "num_hidden": 4})
    assert isinstance(out, mx.nd.NDArray)
    assert out.asnumpy().tolist() == [[1.5] * 4] * 2
    with pytest.raises(ValueError, match="already registered"):
        registry.register("fully_connected")(lambda data: data)
    assert registry.get_op("_attention_decode").namespaces == ()
