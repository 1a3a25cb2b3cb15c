"""``dist_sync`` over two processes: the port against the JAX package's
two-process launch, on the CPU over gloo.

One JAX launch (``tests/_dist_harness.run_launched_workers``) and one
port launch (``mxnet_tpu_torch.tools.launch.run_local``) each run, per
rank:

- the kvstore scenario of ``tests/test_dist_multiprocess.py``: each
  rank pushes rank + 1, both pull 3 (exact);
- a two-layer MLP under ``gluon.Trainer(kvstore="dist_sync")`` for
  three SGD-momentum steps on the rank's own batch, weights carried
  from the JAX package's initial values (the same on both ranks). Each
  step saves every gradient before the reduction and after ``step``.

The port runs the MLP twice from the same weights, with
``MXNET_ASYNC_GRAD_SYNC`` on (buckets of 1 KiB, so several dispatch
during backward) and off. Bounds: the parameters within rtol 1e-5,
atol 1e-6 of the JAX package's; each package's reduced gradient
bitwise equal to the sum of its two ranks' gradients (one float32 add);
the port's runs with the reducer on and off bitwise equal; the ranks'
parameters bitwise equal.
"""
import json
import sys

import numpy as onp
import pytest

from _dist_harness import REPO, run_launched_workers

from mxnet_tpu_torch.tools import launch

STEPS = 3

JAX_BODY = r"""
import numpy as onp
import mxnet_tpu as mx
from mxnet_tpu import nd, kv, autograd, gluon

store = kv.create("dist_sync")
rank, n = store.rank, store.num_workers
assert n == 2, n
store.init(3, nd.zeros((4,)))
store.push(3, nd.array(onp.full(4, float(rank + 1), "f")))
out = nd.zeros((4,))
store.pull(3, out=out)

mx.random.seed(0)
net = gluon.nn.HybridSequential(prefix="mlp_")
with net.name_scope():
    net.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(4))
net.initialize(mx.init.Xavier())
rs = onp.random.RandomState(100 + rank)
xs = [rs.randn(8, 10).astype("f") for _ in range({steps})]
ys = [rs.randint(0, 4, 8).astype("f") for _ in range({steps})]
net(nd.array(xs[0]))
res = {{"kv": out.asnumpy()}}
params = net._collect_params_with_prefix()
for k, p in params.items():
    res["init/" + k] = p.data().asnumpy()
tr = gluon.Trainer(net.collect_params(), "sgd",
                   {{"learning_rate": 0.1, "momentum": 0.9}},
                   kvstore="dist_sync")
lf = gluon.loss.SoftmaxCrossEntropyLoss()
for s in range({steps}):
    with autograd.record():
        loss = lf(net(nd.array(xs[s])), nd.array(ys[s]))
    loss.backward()
    for k, p in params.items():
        res["s%d/local/%s" % (s, k)] = p.grad().asnumpy().copy()
    tr.step(8)
    for k, p in params.items():
        res["s%d/reduced/%s" % (s, k)] = p.grad().asnumpy().copy()
for k, p in params.items():
    res["final/" + k] = p.data().asnumpy()
store.barrier()
onp.savez(os.path.join({outdir!r}, "jax%d.npz" % rank), **res)
"""

PORT_BODY = r"""
import os, sys
import numpy as onp
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd
from mxnet_tpu_torch.tools import launch

outdir, steps = sys.argv[1], int(sys.argv[2])
CPU = mx.cpu()
store = mx.kv.create("dist_sync")
rank, n = store.rank, store.num_workers
store.init(3, nd.zeros((4,), ctx=CPU))
store.push(3, nd.array(onp.full(4, float(rank + 1), "f"), ctx=CPU))
out = nd.zeros((4,), ctx=CPU)
store.pull(3, out=out)
res = {"kv": out.asnumpy()}
ref = onp.load(os.path.join(outdir, "jax0.npz"))
init = {k[5:]: ref[k] for k in ref.files if k.startswith("init/")}
rs = onp.random.RandomState(100 + rank)
xs = [rs.randn(8, 10).astype("f") for _ in range(steps)]
ys = [rs.randint(0, 4, 8).astype("f") for _ in range(steps)]
net = gluon.nn.HybridSequential()
net.add(gluon.nn.Dense(32, activation="relu", in_units=10),
        gluon.nn.Dense(4, in_units=32))
net.initialize(ctx=CPU)
params = net._collect_params_with_prefix()
lf = gluon.loss.SoftmaxCrossEntropyLoss()
for flag in ("1", "0"):
    os.environ["MXNET_ASYNC_GRAD_SYNC"] = flag
    convert.params_from_numpy(net, init, ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       kvstore="dist_sync")
    mx.pipeline.reset_pipeline_counters()
    for s in range(steps):
        with autograd.record():
            loss = lf(net(nd.array(xs[s], ctx=CPU)), nd.array(ys[s], ctx=CPU))
        loss.backward()
        for k, p in params.items():
            res["%s/s%d/local/%s" % (flag, s, k)] = p.grad().asnumpy().copy()
        tr.step(8)
        for k, p in params.items():
            res["%s/s%d/reduced/%s" % (flag, s, k)] = \
                p.grad().asnumpy().copy()
    for k, p in params.items():
        res["%s/final/%s" % (flag, k)] = p.data().asnumpy()
    res["%s/buckets_in_backward" % flag] = onp.array(
        mx.pipeline.pipeline_counters()["grad_buckets"])
    del tr

# a Module under dist_sync sums over the ranks too
sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
    mx.sym.Variable("data"), num_hidden=4, name="fc"),
    mx.sym.Variable("softmax_label"), name="softmax")
mod = mx.mod.Module(sym, context=CPU)
mod.bind([("data", (8, 10))], [("softmax_label", (8,))])
mod.init_params(mx.init.Constant(0.01))
mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                   optimizer_params=(("learning_rate", 0.5),))
mod.forward(mx.io.DataBatch([nd.array(xs[0], ctx=CPU)],
                            [nd.array(ys[0], ctx=CPU)]), is_train=True)
mod.backward()
mod.update()
res["module_w"] = mod.get_params()[0]["fc_weight"].asnumpy()
res["backend"] = onp.array(launch.backend())
store.barrier()
onp.savez(os.path.join(outdir, "port%d.npz" % rank), **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_sync")
    run_launched_workers(tmp, JAX_BODY.replace("{steps}", str(STEPS)), n=2,
                         timeout=240)
    worker = tmp / "port_worker.py"
    worker.write_text(PORT_BODY)
    proc = launch.run_local(
        [sys.executable, str(worker), str(tmp), str(STEPS)], 2,
        env={"MXNET_DIST_DEVICE": "cpu", "MXNET_GRAD_BUCKET_KB": "1",
             "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO},
        timeout=240, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return ({r: dict(onp.load(tmp / f"jax{r}.npz")) for r in (0, 1)},
            {r: dict(onp.load(tmp / f"port{r}.npz")) for r in (0, 1)})


def _names(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


def test_kvstore_scenario_sums_over_two_processes_exactly(runs):
    jax_res, port = runs
    for r in (0, 1):
        onp.testing.assert_array_equal(port[r]["kv"], onp.full(4, 3.0, "f"))
        onp.testing.assert_array_equal(port[r]["kv"], jax_res[r]["kv"])
        assert str(port[r]["backend"]) == "gloo"  # the CPU's backend


def test_mlp_trainer_matches_the_jax_two_process_run(runs):
    jax_res, port = runs
    names = _names(jax_res[0], "final/")
    assert names and names == _names(port[0], "1/final/")
    for r in (0, 1):
        for k in names:
            onp.testing.assert_allclose(port[r]["1/final/" + k],
                                        jax_res[r]["final/" + k],
                                        rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_reduced_gradient_is_the_ranks_sum_bitwise(runs, pkg):
    res = runs[0] if pkg == "jax" else runs[1]
    pre = "" if pkg == "jax" else "1/"
    for s in range(STEPS):
        for k in _names(res[0], f"{pre}s{s}/local/"):
            want = res[0][f"{pre}s{s}/local/{k}"] + \
                res[1][f"{pre}s{s}/local/{k}"]
            for r in (0, 1):
                onp.testing.assert_array_equal(
                    res[r][f"{pre}s{s}/reduced/{k}"], want, err_msg=k)


def test_reducer_on_and_off_bitwise_and_ranks_agree(runs):
    _, port = runs
    assert int(port[0]["1/buckets_in_backward"]) > 0
    assert int(port[0]["0/buckets_in_backward"]) == 0
    for k in _names(port[0], "1/final/"):
        for r in (0, 1):
            onp.testing.assert_array_equal(port[r]["1/final/" + k],
                                           port[r]["0/final/" + k])
        onp.testing.assert_array_equal(port[0]["1/final/" + k],
                                       port[1]["1/final/" + k])
    onp.testing.assert_array_equal(port[0]["module_w"], port[1]["module_w"])


def test_profile_dist_at_toy_size_on_the_cpu(tmp_path):
    """``tools/profile_dist.py``, the card's ResNet-50 driver, run through
    the launcher by two CPU ranks at toy size: its per-step checks (the
    reduced gradient bitwise the ranks' sum, the ranks' parameters
    equal), the reducer on and off bitwise, and compression's codes
    against the host's all hold."""
    proc = launch.run_local(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.profile_dist", "--cpu",
         "--model", "resnet18_v1", "--image", "16", "--classes", "10",
         "--batch", "2", "--warmup", "1", "--steps", "2", "--check",
         "--compare-sync", "1", "--compression", "1", "--out",
         str(tmp_path)], 2,
        env={"MXNET_DIST_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
             "MXNET_GRAD_BUCKET_KB": "256", "PYTHONPATH": REPO},
        timeout=240, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    for r in (0, 1):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["backend"] == "gloo" and res["start_weights_equal"]
        checks = res["train"]["checks"]
        assert len(checks) == 2 and all(
            c["reduced_is_sum"] and c["params_equal"] for c in checks)
        assert res["train"]["buckets_in_backward"] > 0
        assert res["compare_sync"]["bitwise_equal"]
        (c,) = res["compression"]["steps"]
        assert c["codes_equal"] and c["residuals_equal"] and \
            c["kept_residual_equal"] and c["nonzero_codes"] > 0
