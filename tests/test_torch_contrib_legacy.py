"""The legacy contrib shims of the PyTorch port against the JAX
package's, on the CPU (``mxnet_tpu_torch/contrib/{autograd,io,ndarray,
symbol}.py`` against ``mxnet_tpu/contrib/``): twins of
``tests/test_contrib_tail.py::test_legacy_contrib_autograd_api`` and
``::test_legacy_contrib_dataloader_iter``. Values are made with numpy
from a seed; gradients and outputs agree exactly (single products).
"""
import numpy as onp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import autograd as jcag

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.contrib import autograd as cag

CPU = mx.cpu()


def _arr(pkg_nd, v):
    return pkg_nd.array(v, ctx=CPU) if pkg_nd is nd else pkg_nd.array(v)


def test_legacy_contrib_autograd_api_equals_jax():
    rs = onp.random.RandomState(0)
    a_np = rs.randn(3).astype("float32")
    b_np = rs.randn(3).astype("float32")
    got = {}
    for tag, pkg_nd, c, a_mod in (("t", nd, cag, ag), ("j", jnd, jcag, jag)):
        @c.grad_and_loss
        def f(a, b):
            return a * b

        grads, out = f(_arr(pkg_nd, a_np), _arr(pkg_nd, b_np))

        @c.grad
        def g(a):
            return a * a

        (ga,) = g(_arr(pkg_nd, a_np))

        (gb,), _ = c.grad_and_loss(lambda a, b: a * b + a, argnum=1)(
            _arr(pkg_nd, a_np), _arr(pkg_nd, b_np))

        x = _arr(pkg_nd, onp.ones(3, "float32"))
        x.attach_grad()
        with c.train_section():
            assert a_mod.is_recording() and a_mod.is_training()
            y = (x * x).sum()
            with c.test_section():
                assert not a_mod.is_recording()
                assert not a_mod.is_training()
            assert a_mod.is_recording()
        assert not a_mod.is_recording()
        c.compute_gradient([y])
        prev = c.set_is_training(True)
        assert prev is False and a_mod.is_recording()
        assert c.set_is_training(False) is True
        assert not a_mod.is_recording() and not a_mod.is_training()
        got[tag] = ([v.asnumpy() for v in grads], out.asnumpy(),
                    ga.asnumpy(), gb.asnumpy(), x.grad.asnumpy())
    t, j = got["t"], got["j"]
    for a, b in zip(t[0], j[0]):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(t[1:], j[1:]):
        assert a.tobytes() == b.tobytes()
    assert t[4].tolist() == [2.0] * 3
    onp.testing.assert_array_equal(t[0][0], b_np)
    onp.testing.assert_array_equal(t[3], a_np)


def test_legacy_set_is_training_records_ops():
    """``set_is_training(True)`` records the ops that follow, as the
    reference's (and the JAX shim's) does; backward then fills the
    marked gradient."""
    for pkg_nd, c, a_mod in ((nd, cag, ag), (jnd, jcag, jag)):
        x = _arr(pkg_nd, onp.array([3.0], "float32"))
        x.attach_grad()
        c.set_is_training(True)
        try:
            y = x * x * 2.0
        finally:
            c.set_is_training(False)
        c.backward([y])
        assert x.grad.asnumpy().tolist() == [12.0]


def test_legacy_contrib_dataloader_iter_equals_jax():
    got = {}
    for tag, pkg, pkg_nd in (("t", mx, nd), ("j", jmx, jnd)):
        from importlib import import_module

        data = import_module(pkg.__name__ + ".gluon.data")
        ds = data.ArrayDataset(
            _arr(pkg_nd, onp.arange(10, dtype="float32").reshape(5, 2)),
            _arr(pkg_nd, onp.arange(5, dtype="float32")))
        it = pkg.contrib.io.DataLoaderIter(data.DataLoader(ds,
                                                           batch_size=2))
        desc = (it.provide_data[0].name, tuple(it.provide_data[0].shape),
                it.provide_label[0].name, tuple(it.provide_label[0].shape),
                it.batch_size)
        first = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
        it.reset()
        again = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
        got[tag] = (desc, first, again)
    assert got["t"][0] == got["j"][0] == ("data", (2, 2), "softmax_label",
                                          (2,), 2)
    for run in (1, 2):
        assert len(got["t"][run]) == len(got["j"][run]) == 3
        for (td, tl), (jd, jl) in zip(got["t"][run], got["j"][run]):
            onp.testing.assert_array_equal(td, jd)
            onp.testing.assert_array_equal(tl, jl)


def test_contrib_namespaces_follow_nd_and_sym_contrib():
    """``mx.contrib.ndarray`` and ``mx.contrib.symbol`` hold the names of
    ``nd.contrib`` and ``sym.contrib``, the JAX shims' names among them."""
    from mxnet_tpu.contrib import ndarray as jcnd
    from mxnet_tpu.contrib import symbol as jcsym

    tn = {n for n in dir(mx.contrib.ndarray) if not n.startswith("_")}
    ts = {n for n in dir(mx.contrib.symbol) if not n.startswith("_")}
    assert mx.contrib.ndarray.box_nms is mx.nd.contrib.box_nms
    assert mx.contrib.symbol.MultiBoxPrior is mx.sym.contrib.MultiBoxPrior
    jops_nd = {n for n in dir(jcnd) if not n.startswith("_")
               and callable(getattr(jcnd, n))}
    jops_sym = {n for n in dir(jcsym) if not n.startswith("_")
                and callable(getattr(jcsym, n))}
    assert {"box_nms", "MultiBoxPrior", "MultiBoxDetection",
            "ROIAlign"} <= tn & jops_nd
    assert {"box_nms", "MultiBoxPrior", "MultiBoxDetection"} <= \
        ts & jops_sym
