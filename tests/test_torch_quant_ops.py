"""The quantization ops of the PyTorch port against the JAX package, on
the CPU.

Every op of ``ndarray/ops_quant.py`` (quantize, quantize_v2, dequantize,
requantize, the nine ``_contrib_quantized_*`` ops and calibrate_entropy)
runs on the inputs of ``tools/profile_quant.op_cases`` — int8 and uint8
payloads, drawn from a numpy seed — in both packages, under each
lowering (``MXNET_QUANTIZE_LOWERING`` patched per case, as
``tests/test_quantization_pass.py`` patches it). On the CPU the port's
``native`` contractions run their kernels' plain versions (float64,
exact), the JAX ones int8 XLA ops.

Tolerances: integer outputs (codes, int32 accumulators) equal exactly,
dtype included; float outputs and ranges within 1e-6 relative.

Also: the ``nd``/``sym`` names and the reference's legacy aliases, three
outputs per symbol node, the lowering rule, the shape and dtype rules of
the quantized ops and their offline weight variables, and the meta
route shape inference takes through the int8 kernels' wrappers.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ndarray import ops_quant as jops
from mxnet_tpu.ndarray import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch.kernels import int8_conv as k8
from mxnet_tpu_torch.ndarray import ops_quant
from mxnet_tpu_torch.ndarray import registry as treg
from mxnet_tpu_torch.tools.profile_quant import op_cases

TOL = 1e-6
CASES = op_cases(onp.random.RandomState(20240917))
OPS = ("quantize", "quantize_v2", "dequantize", "requantize",
       "_contrib_quantized_act", "_contrib_quantized_flatten",
       "_contrib_quantized_pooling", "_contrib_quantized_elemwise_add",
       "_contrib_quantized_concat", "_contrib_quantized_batch_norm",
       "_contrib_quantized_conv", "_contrib_quantized_fully_connected",
       "_contrib_quantized_batch_dot", "calibrate_entropy")


def _outs(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _check(got, want, what):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "iub":
        onp.testing.assert_array_equal(got, want, err_msg=what)
    else:
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=0,
                                    err_msg=what)


@pytest.mark.parametrize("lowering", ["native", "dequant"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_against_jax(case, lowering, monkeypatch):
    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", lowering)
    label, op, args, kw = case
    want = jreg.get_op(op).fn(*[jnp.asarray(a) for a in args], **kw)
    got = treg.get_op(op).fn(*[torch.from_numpy(onp.ascontiguousarray(a))
                               for a in args], **kw)
    want, got = _outs(want), _outs(got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g.numpy(), onp.asarray(w), f"{label} output {i}")


def test_every_op_is_covered_and_named():
    assert {c[1] for c in CASES} == set(OPS)
    for op in OPS:
        assert treg.get_op(op) is not None, op
        assert callable(getattr(nd, op)), op
        assert callable(getattr(sym, op)), op
    for legacy, target in (("_contrib_quantize", "quantize"),
                           ("_contrib_quantize_v2", "quantize_v2"),
                           ("_contrib_dequantize", "dequantize"),
                           ("_contrib_requantize", "requantize")):
        assert getattr(sym, legacy) is getattr(sym, target)
        assert getattr(nd, legacy) is getattr(nd, target)


def test_nd_call_keeps_ranges_on_the_device():
    x = nd.array(onp.linspace(-2, 3, 24, dtype="float32").reshape(2, 12),
                 ctx=mx.cpu())
    q, mn, mx_ = nd.quantize_v2(x, min_calib_range=-2.0,
                                max_calib_range=3.0)
    assert q.dtype == onp.int8 and mn.shape == () and mx_.shape == ()
    assert float(mx_.asnumpy()) == 3.0
    back = nd.dequantize(q, mn, mx_)
    assert float(abs(back.asnumpy() - x.asnumpy()).max()) <= 3.0 / 127


@pytest.mark.parametrize("op", [
    "quantize", "quantize_v2", "requantize", "_contrib_quantized_conv",
    "_contrib_quantized_fully_connected", "_contrib_quantized_batch_dot",
    "_contrib_quantized_act", "_contrib_quantized_pooling",
    "_contrib_quantized_elemwise_add", "_contrib_quantized_concat",
    "_contrib_quantized_batch_norm", "_contrib_quantized_flatten"])
def test_symbol_nodes_have_three_outputs(op):
    from mxnet_tpu import symbol as jsym
    from mxnet_tpu_torch.symbol import _num_outputs_for

    assert _num_outputs_for(op, {}) == jsym._num_outputs_for(op, {}) == 3


def test_lowering_rule(monkeypatch):
    monkeypatch.delenv("MXNET_QUANTIZE_LOWERING", raising=False)
    cpu = torch.zeros(1)
    assert ops_quant.lowering(cpu) == "dequant"
    assert ops_quant.lowering(torch.device("cuda", 0)) == "native"
    assert ops_quant.lowering() == "dequant"
    for mode in ("native", "dequant"):
        monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", mode)
        assert ops_quant.lowering(cpu) == mode
        assert ops_quant.lowering(torch.device("cuda")) == mode
        assert jops.lowering() == mode
    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", "fast")
    with pytest.raises(ValueError) as tp:
        ops_quant.lowering(cpu)
    with pytest.raises(ValueError) as jx:
        jops.lowering()
    assert str(tp.value) == str(jx.value)


def _qconv_graph(S):
    data = S.var("data")
    q = S.quantize_v2(data, name="q0")
    c = S._contrib_quantized_conv(
        q[0], S.var("w_quantized"), q[1], q[2], S.var("w_min"),
        S.var("w_max"), S.var("b"), kernel=(3, 3), num_filter=5, pad=(1, 1),
        name="qconv")
    r = S.requantize(c[0], c[1], c[2], name="rq")
    f = S._contrib_quantized_fully_connected(
        r[0], S.var("fw_quantized"), r[1], r[2], S.var("fw_min"),
        S.var("fw_max"), num_hidden=4, no_bias=True, name="qfc")
    return S.dequantize(f[0], f[1], f[2], name="deq")


def test_shape_and_dtype_rules_match_jax():
    from mxnet_tpu import sym as jsym

    js, ts = _qconv_graph(jsym), _qconv_graph(sym)
    assert ts.list_arguments() == js.list_arguments()
    ja, jo, _ = js.infer_shape(data=(2, 3, 6, 6))
    ta, to, _ = ts.infer_shape(data=(2, 3, 6, 6))
    assert [tuple(s) for s in ta] == [tuple(s) for s in ja]
    assert [tuple(s) for s in to] == [tuple(s) for s in jo] == [(2, 4)]
    jt, jot, _ = js.infer_type(data="float32")
    tt, tot, _ = ts.infer_type(data="float32")
    assert [onp.dtype(d) for d in tt] == [onp.dtype(d) for d in jt]
    assert [onp.dtype(d) for d in tot] == [onp.dtype(d) for d in jot]
    types = dict(zip(ts.list_arguments(), tt))
    assert types["w_quantized"] == onp.int8 and types["w_min"] == onp.float32


@pytest.mark.parametrize("lowering", ["native", "dequant"])
def test_meta_route_through_the_int8_wrappers(lowering, monkeypatch):
    """Shape inference runs the op bodies on meta tensors: the int8
    wrappers answer with empty int32 results of the right shape."""
    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", lowering)
    meta = torch.device("meta")
    x = torch.empty((2, 4, 9, 9), dtype=torch.int8, device=meta)
    w = torch.empty((6, 2, 3, 3), dtype=torch.int8, device=meta)
    y = k8.int8_conv(x, w, (2, 2), (1, 1), (1, 1), 2)
    assert y.dtype == torch.int32 and tuple(y.shape) == (2, 6, 5, 5)
    a = torch.empty((3, 8), dtype=torch.int8, device=meta)
    b = torch.empty((8, 5), dtype=torch.int8, device=meta)
    assert tuple(k8.int8_mm(a, b).shape) == (3, 5)
    assert tuple(k8.int8_batch_mm(a[None], b[None]).shape) == (1, 3, 5)
