"""The port fixes its own float32 convolution precision on the CPU side
of the contract: ``convolution`` (forward) and ``autograd.backward`` run
cuDNN inside ``torch.backends.cudnn.flags(allow_tf32=False, ...)``,
whatever torch's global flag says (its default is True), and map
``MXNET_CUDNN_AUTOTUNE_DEFAULT`` to ``benchmark`` (0 off, 1 or 2 on,
MXNet's default 1). The scope is checked by patching ``flags``; the
card test in ``test_torch_cuda.py`` holds the numbers (rtol 1e-3 of the
CPU at torch's default global flags).
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.ndarray import ops_nn


@pytest.fixture
def scopes(monkeypatch):
    """Every ``cudnn.flags`` call: its keyword arguments, in order."""
    calls = []
    real = torch.backends.cudnn.flags

    @contextlib.contextmanager
    def recorder(**kw):
        calls.append(kw)
        with real(**kw):
            yield

    monkeypatch.setattr(torch.backends.cudnn, "flags", recorder)
    return calls


def _conv(x, w, **kw):
    return nd.convolution(x, w, kernel=(3, 3), num_filter=w.shape[0],
                          no_bias=True, **kw)


@pytest.mark.parametrize("env,bench", [(None, True), ("0", False),
                                       ("1", True), ("2", True)])
def test_convolution_scopes_fp32_and_autotune(scopes, monkeypatch, env,
                                              bench):
    if env is None:
        monkeypatch.delenv("MXNET_CUDNN_AUTOTUNE_DEFAULT", raising=False)
    else:
        monkeypatch.setenv("MXNET_CUDNN_AUTOTUNE_DEFAULT", env)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    rs = onp.random.RandomState(0)
    x = nd.array(rs.randn(2, 3, 8, 8).astype("float32"), ctx=mx.cpu())
    w = nd.array(rs.randn(4, 3, 3, 3).astype("float32"), ctx=mx.cpu())
    out = _conv(x, w)
    assert scopes == [dict(enabled=torch.backends.cudnn.enabled,
                           benchmark=bench,
                           deterministic=torch.backends.cudnn.deterministic,
                           allow_tf32=False, **ops_nn._IEEE)]
    # the global flags are untouched after the call
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark) == before
    want = torch.nn.functional.conv2d(x.data, w.data)
    assert torch.equal(out.data, want)


def test_scope_asks_for_ieee_float32():
    """Inside the scope cuDNN's float32 convolutions are IEEE float32 in
    every form this torch knows, and the global flags come back after."""
    before = torch.backends.cudnn.allow_tf32
    with ops_nn.cudnn_fp32():
        assert torch.backends.cudnn.allow_tf32 is False
        if ops_nn._IEEE:
            assert torch.backends.cudnn.conv.fp32_precision == "ieee"
    assert torch.backends.cudnn.allow_tf32 == before


def test_backward_runs_in_the_same_scope(scopes):
    rs = onp.random.RandomState(1)
    x = nd.array(rs.randn(1, 2, 6, 6).astype("float32"), ctx=mx.cpu())
    w = nd.array(rs.randn(3, 2, 3, 3).astype("float32"), ctx=mx.cpu())
    w.attach_grad()
    with autograd.record():
        y = _conv(x, w, layout="NCHW").sum()
    y.backward()
    assert len(scopes) == 2 and all(not s["allow_tf32"] for s in scopes)
    xt = x.data.detach().clone()
    wt = w.data.detach().clone().requires_grad_(True)
    torch.nn.functional.conv2d(xt, wt).sum().backward()
    assert torch.equal(w.grad.data, wt.grad)
