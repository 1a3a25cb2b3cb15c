"""A narrow ResNet v1 trained by two ``dist_sync`` processes: the port
against the JAX package's two-process launch, on the CPU over gloo.

``ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64], classes=10,
thumbnail=True)`` at 32 x 32, batch 4 a rank, three SGD steps (0.1,
0.9, 1e-4) under ``gluon.Trainer(kvstore="dist_sync")``, weights and
running statistics carried from the JAX package's initial values. (With
the stem's stride and pool the last stage holds one position an image
and batch norm's backward turns float32 rounding into 26% of a
gradient, ``tests/test_torch_resnet.py``; the thumbnail stem keeps 4 x
4 there, and the port's float32 and float64 runs of these steps agree
within 5% of the bound below.) Widths that stay equal across a strided
stage (``[8, 8, 16, 16, 32]``) have no downsample in either package's
``BasicBlockV1``, so the widths double.

Bounds: every parameter and running statistic within rtol 1e-5, atol
1e-6 of the JAX package's; the port's reduced gradient bitwise the sum
of its ranks' gradients; the port's runs with the bucketed reducer on
and off bitwise equal.

Both launches start from a stated environment (:func:`_stated_environ`):
the pytest worker's, less every ``MXNET_`` variable, with the compile
cache's disk tier off. A worker's ``MXNET_COMPILE_CACHE_DIR`` (the
session's cache, ``tests/conftest.py``) holds what every earlier test in
that worker persisted; ``tests/test_torch_recordio.py`` trains this
network in one JAX process, and the JAX package's executables of that
run, loaded by the two-process ranks, fail them ("CopyArrays only
supports destination device list of the same size").
"""
import contextlib
import os
import sys

import numpy as onp
import pytest

from _dist_harness import REPO, run_launched_workers

from mxnet_tpu_torch.tools import launch

STEPS = 3

JAX_BODY = r"""
import numpy as onp
import mxnet_tpu as mx
from mxnet_tpu import nd, autograd, gluon
from mxnet_tpu.gluon.model_zoo.vision.resnet import ResNetV1, BasicBlockV1

rank = mx.kv.create("dist_sync").rank
mx.random.seed(0)
net = ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64], classes=10,
               thumbnail=True, prefix="rn_")
net.initialize(mx.init.Xavier())
net.hybridize()  # one XLA program: the launch compiles once
rs = onp.random.RandomState(200 + rank)
xs = [rs.randn(4, 3, 32, 32).astype("f") for _ in range(STEPS)]
ys = [rs.randint(0, 10, 4).astype("f") for _ in range(STEPS)]
net(nd.array(xs[0]))
params = net._collect_params_with_prefix()
res = {{}}
for k, p in params.items():
    res["init/" + k] = p.data().asnumpy()
tr = gluon.Trainer(net.collect_params(), "sgd",
                   {{"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}},
                   kvstore="dist_sync")
lf = gluon.loss.SoftmaxCrossEntropyLoss()
for s in range(STEPS):
    with autograd.record():
        loss = lf(net(nd.array(xs[s])), nd.array(ys[s]))
    loss.backward()
    tr.step(8)
for k, p in params.items():
    res["final/" + k] = p.data().asnumpy()
res["env/mxnet"] = onp.array(sorted(k for k in os.environ
                                    if k.startswith("MXNET_")))
onp.savez(os.path.join({outdir!r}, "jax%d.npz" % rank), **res)
"""

PORT_BODY = r"""
import os, sys
import numpy as onp
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (ResNetV1,
                                                           BasicBlockV1)

outdir, steps = sys.argv[1], int(sys.argv[2])
CPU = mx.cpu()
rank = mx.kv.create("dist_sync").rank
ref = onp.load(os.path.join(outdir, "jax0.npz"))
init = {k[5:]: ref[k] for k in ref.files if k.startswith("init/")}
rs = onp.random.RandomState(200 + rank)
xs = [rs.randn(4, 3, 32, 32).astype("f") for _ in range(steps)]
ys = [rs.randint(0, 10, 4).astype("f") for _ in range(steps)]
net = ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64], classes=10,
               thumbnail=True)
net.initialize(ctx=CPU)
net(nd.array(xs[0], ctx=CPU))
params = net._collect_params_with_prefix()
lf = gluon.loss.SoftmaxCrossEntropyLoss()
res = {}
for flag in ("1", "0"):
    os.environ["MXNET_ASYNC_GRAD_SYNC"] = flag
    convert.params_from_numpy(net, init, ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
                       kvstore="dist_sync")
    for s in range(steps):
        with autograd.record():
            loss = lf(net(nd.array(xs[s], ctx=CPU)), nd.array(ys[s], ctx=CPU))
        loss.backward()
        for k, p in params.items():
            if p.grad_req != "null":
                res["%s/s%d/local/%s" % (flag, s, k)] = \
                    p.grad().asnumpy().copy()
        tr.step(8)
        for k, p in params.items():
            if p.grad_req != "null":
                res["%s/s%d/reduced/%s" % (flag, s, k)] = \
                    p.grad().asnumpy().copy()
    for k, p in params.items():
        res["%s/final/%s" % (flag, k)] = p.data().asnumpy()
    del tr
mx.kv.create("dist_sync").barrier()
res["env/mxnet"] = onp.array(sorted(k for k in os.environ
                                    if k.startswith("MXNET_")))
onp.savez(os.path.join(outdir, "port%d.npz" % rank), **res)
"""


@contextlib.contextmanager
def _stated_environ():
    """This worker's environment less every ``MXNET_`` variable, with the
    compile cache's disk tier off: what both launches hand their ranks."""
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("MXNET_")]:
            mp.delenv(k)
        mp.setenv("MXNET_COMPILE_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_resnet")
    with _stated_environ():
        run_launched_workers(tmp, JAX_BODY.replace("STEPS", str(STEPS)), n=2,
                             timeout=300)
        worker = tmp / "port_worker.py"
        worker.write_text(PORT_BODY)
        proc = launch.run_local(
            [sys.executable, str(worker), str(tmp), str(STEPS)], 2,
            env={"MXNET_DIST_DEVICE": "cpu", "MXNET_GRAD_BUCKET_KB": "16",
                 "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO},
            timeout=240, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return ({r: dict(onp.load(tmp / f"jax{r}.npz")) for r in (0, 1)},
            {r: dict(onp.load(tmp / f"port{r}.npz")) for r in (0, 1)})


def _names(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


@pytest.mark.parametrize("rank", [0, 1])
def test_narrow_resnet_matches_the_jax_two_process_run(runs, rank):
    jax_res, port = runs
    names = _names(jax_res[rank], "final/")
    assert len(names) == len(_names(port[rank], "1/final/")) > 20
    for k in names:
        onp.testing.assert_allclose(port[rank]["1/final/" + k],
                                    jax_res[rank]["final/" + k],
                                    rtol=1e-5, atol=1e-6, err_msg=k)


def test_reduced_gradient_is_the_ranks_sum_bitwise(runs):
    _, port = runs
    for flag in ("1", "0"):
        for s in range(STEPS):
            pre = f"{flag}/s{s}/"
            for k in _names(port[0], pre + "local/"):
                want = port[0][pre + "local/" + k] + port[1][pre + "local/" + k]
                for r in (0, 1):
                    onp.testing.assert_array_equal(
                        port[r][pre + "reduced/" + k], want, err_msg=k)


def test_reducer_on_and_off_bitwise(runs):
    _, port = runs
    for k in _names(port[0], "1/final/"):
        for r in (0, 1):
            onp.testing.assert_array_equal(port[r]["1/final/" + k],
                                           port[r]["0/final/" + k])


def test_the_launches_start_from_a_stated_environment(runs):
    """The fault a whole-suite run met: the ranks inherited the worker's
    ``MXNET_COMPILE_CACHE_DIR``, a cache that earlier tests of the worker
    had filled. Every rank of both launches saw none of the worker's
    ``MXNET_`` variables, the disk tier off, and the launcher's own."""
    jax_res, port = runs
    for res in (*jax_res.values(), *port.values()):
        seen = set(res["env/mxnet"].tolist())
        assert "MXNET_COMPILE_CACHE_DIR" not in seen
        assert "MXNET_LOCK_CHECK" not in seen
        assert "MXNET_COMPILE_CACHE" in seen
    assert all(set(port[r]["env/mxnet"].tolist()) == {
        "MXNET_COMPILE_CACHE", "MXNET_COORDINATOR", "MXNET_DIST_DEVICE",
        "MXNET_GRAD_BUCKET_KB", "MXNET_LOCAL_RANK", "MXNET_LOCAL_SIZE",
        "MXNET_NUM_PROCESSES", "MXNET_PROCESS_ID",
        "MXNET_ASYNC_GRAD_SYNC"} for r in (0, 1))
