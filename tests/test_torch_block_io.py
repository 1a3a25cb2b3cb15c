"""Block checkpoints and exports interchanged with the JAX package.

``save_parameters`` writes the reference's binary format keyed by
structural name, through the port's ``nd.save``, which writes the JAX
package's bytes for the same values; ``export`` writes nnvm JSON traced
with ``F = sym`` and ``arg:``/``aux:``-prefixed parameters. Each file
is loaded by the other package. Weights are built in JAX (Xavier) and
carried across with ``convert.params_from_numpy``; inputs come from
numpy seeds.

Tolerances: parameters round-trip bitwise (a file is bytes); outputs of
an imported export within 1e-5 of the largest magnitude (torch and XLA
sum convolutions and products in other orders).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, gluon, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(a):
    return nd.array(a, ctx=mx.cpu())


def _close(got, want, tol, what=""):
    scale = float(onp.abs(want).max()) or 1.0
    err = float(onp.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _mlp(nnmod, prefix):
    net = nnmod.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nnmod.Dense(6, activation="relu", in_units=4),
                nnmod.BatchNorm(in_channels=6), nnmod.Dense(3, in_units=6))
    return net


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _resnet_pair(tag):
    jmx.random.seed(1)
    jnet = jvision.resnet18_v1(thumbnail=True, classes=10,
                               prefix=f"blockio_{tag}_")
    jnet.initialize(jmx.init.Xavier())
    x = onp.random.RandomState(3).randn(2, 3, 32, 32).astype("f")
    with jautograd.pause():
        jnet(jnd.array(x))
    tnet = convert.params_from_numpy(
        vision.resnet18_v1(thumbnail=True, classes=10), _params(jnet),
        ctx=mx.cpu())
    return jnet, tnet, x


def test_save_parameters_bytes_equal_jax_and_load_both_ways(tmp_path):
    jnet, tnet, x = _resnet_pair("save")
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.save_parameters(jfile)
    tnet.save_parameters(tfile)
    with open(jfile, "rb") as a, open(tfile, "rb") as b:
        assert a.read() == b.read()
    # the JAX package loads the port's file, and the other way round
    jmx.random.seed(2)
    jback = jvision.resnet18_v1(thumbnail=True, classes=10,
                                prefix="blockio_back_")
    jback.initialize(jmx.init.Xavier())
    jback.load_parameters(tfile)
    tback = vision.resnet18_v1(thumbnail=True, classes=10)
    tback.initialize(mx.init.Xavier(), ctx=mx.cpu())
    tback.load_parameters(jfile)
    want = _params(jnet)
    for k, v in _params(jback).items():
        onp.testing.assert_array_equal(v, want[k], err_msg=k)
    for k, v in _params(tback).items():
        onp.testing.assert_array_equal(v, want[k], err_msg=k)
    with jautograd.predict_mode():
        jy = jnet(jnd.array(x)).asnumpy()
    _close(tback(_port(x)).asnumpy(), jy, TOL, "loaded forward")


def test_load_parameters_deferred_missing_extra_and_cast(tmp_path):
    f = str(tmp_path / "m.params")
    src = _mlp(nn, "src_")
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    src.save_parameters(f)
    # deferred parameters take their shapes from the file, on ctx
    dst = nn.HybridSequential()
    dst.add(nn.Dense(6, activation="relu"), nn.BatchNorm(), nn.Dense(3))
    dst.load_parameters(f, ctx=mx.cpu())
    for k, v in _params(src).items():
        onp.testing.assert_array_equal(_params(dst)[k], v)
    # a missing parameter raises, unless allow_missing
    small = nn.HybridSequential()
    small.add(nn.Dense(6, activation="relu", in_units=4))
    with pytest.raises(IOError, match="not present"):
        small.load_parameters(f, ctx=mx.cpu())
    small.load_parameters(f, ctx=mx.cpu(), ignore_extra=True)
    big = _mlp(nn, "big_")
    big.add(nn.Dense(2, in_units=3))
    big.initialize(ctx=mx.cpu())
    with pytest.raises(IOError, match="missing"):
        big.load_parameters(f)
    big.load_parameters(f, allow_missing=True)
    # a shape mismatch does not pass (tests/test_gluon2.py:75)
    d = nn.Dense(3, in_units=2)
    d.initialize(ctx=mx.cpu())
    d.save_parameters(str(tmp_path / "d.params"))
    other = nn.Dense(5, in_units=2)
    other.initialize(ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="shape"):
        other.load_parameters(str(tmp_path / "d.params"))
    # cast_dtype with dtype_source="saved" takes the file's dtype
    half = _mlp(nn, "half_")
    half.initialize(ctx=mx.cpu())
    half.cast("float64")
    half.load_parameters(f, cast_dtype=True, dtype_source="saved")
    assert half[0].weight.data().dtype == onp.float32
    keep = _mlp(nn, "keep_")
    keep.initialize(ctx=mx.cpu())
    keep.cast("float64")
    keep.load_parameters(f)
    assert keep[0].weight.data().dtype == onp.float64


def test_load_parameters_reads_export_files_by_full_name(tmp_path):
    jmx.random.seed(4)
    jnet = _mlp(jnn, "exp_")
    jnet.initialize(jmx.init.Xavier())
    x = onp.random.RandomState(0).randn(5, 4).astype("f")
    with jautograd.pause():
        jnet(jnd.array(x))
    prefix = str(tmp_path / "exp")
    jnet.export(prefix)
    tnet = _mlp(nn, "exp_")
    tnet.initialize(ctx=mx.cpu())
    tnet.load_parameters(f"{prefix}-0000.params")
    for k, v in _params(jnet).items():
        onp.testing.assert_array_equal(_params(tnet)[k], v)


def test_port_export_loads_in_jax_symbolblock(tmp_path):
    jnet, tnet, x = _resnet_pair("exp")
    prefix = str(tmp_path / "r18")
    fname = tnet.export(prefix)
    assert fname.endswith("-0000.params")
    sb = jgluon.SymbolBlock.imports(f"{prefix}-symbol.json", ["data"],
                                    fname)
    got = sb(jnd.array(x)).asnumpy()
    want = tnet(_port(x)).asnumpy()
    _close(got, want, TOL, "JAX import of the port's export")
    keys = jnd.load(fname)
    aux = [k for k in keys if k.startswith("aux:")]
    assert len(aux) == 2 * 19 and all(
        k.endswith(("running_mean", "running_var")) for k in aux)


def test_jax_export_loads_in_port_symbolblock(tmp_path):
    jnet, tnet, x = _resnet_pair("jexp")
    prefix = str(tmp_path / "jr18")
    jnet.export(prefix)
    sb = gluon.SymbolBlock.imports(f"{prefix}-symbol.json", ["data"],
                                   f"{prefix}-0000.params", ctx=mx.cpu())
    got = sb(_port(x)).asnumpy()
    with jautograd.predict_mode():
        want = jnet(jnd.array(x)).asnumpy()
    _close(got, want, TOL, "port import of the JAX export")


def test_export_json_matches_jax_structure(tmp_path):
    """Both packages trace the same graph: the same op sequence and the
    same variables (op node names come from each process's name
    counters)."""
    import json

    jmx.random.seed(5)
    jnet = _mlp(jnn, "trace_")
    jnet.initialize(jmx.init.Xavier())
    x = onp.random.RandomState(2).randn(3, 4).astype("f")
    with jautograd.pause():
        jnet(jnd.array(x))
    tnet = convert.params_from_numpy(_mlp(nn, "trace_"), _params(jnet),
                                     ctx=mx.cpu())
    jnet.export(str(tmp_path / "j"))
    tnet.export(str(tmp_path / "t"))
    graphs = []
    for name in ("j", "t"):
        with open(tmp_path / f"{name}-symbol.json") as f:
            g = json.load(f)
        graphs.append([n["name"] if n["op"] == "null" else n["op"]
                       for n in g["nodes"]])
    assert graphs[1] == graphs[0]
    jkeys = sorted(jnd.load(str(tmp_path / "j-0000.params")))
    tkeys = sorted(jnd.load(str(tmp_path / "t-0000.params")))
    assert jkeys == tkeys
    sb = gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"), ["data"],
                                   str(tmp_path / "t-0000.params"),
                                   ctx=mx.cpu())
    _close(sb(_port(x)).asnumpy(), tnet(_port(x)).asnumpy(), TOL,
           "round trip")


def test_save_params_aliases():
    assert nn.Dense.save_params is nn.Dense.save_parameters
    assert nn.Dense.load_params is nn.Dense.load_parameters
