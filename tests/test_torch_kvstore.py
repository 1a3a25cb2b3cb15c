"""The port's kvstore, 2-bit compression, collectives, retry policy,
rendezvous rules and bucketed reducer in one process, against the JAX
package on the CPU.

Inputs come from numpy seeds. Tolerances: sums and updates within
1e-6 (relative, and absolute for values near 0); compression's packed
words equal, its residuals within 1e-7 (the same float32 operations in
the same order); the reducer's sums bitwise equal to the sums at the
step (the reduction is elementwise, whatever the buckets).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.gradient_compression import \
    GradientCompression as JGradientCompression
from mxnet_tpu.resilience import RetryPolicy as JRetryPolicy

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _rendezvous, autograd, gluon, nd, parallel
from mxnet_tpu_torch.gradient_compression import GradientCompression
from mxnet_tpu_torch.pipeline import AsyncGradReducer
from mxnet_tpu_torch.resilience import RetryExhausted, RetryPolicy
from mxnet_tpu_torch.tools import launch

CPU = mx.cpu()
TOL = 1e-6


def _rs(seed):
    return onp.random.RandomState(seed)


def _t(a):
    return nd.array(a, ctx=CPU)


def _close(got, want, tol=TOL):
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _pull(kv, key, shape, pkg):
    out = pkg.nd.zeros(shape, ctx=CPU) if pkg is mx else pkg.nd.zeros(shape)
    kv.pull(key, out=out)
    return out.asnumpy()


# -- the store in one process ------------------------------------------------

@pytest.mark.parametrize("kind", ["local", "device", "nccl", "dist_sync"])
def test_init_list_push_and_pull_match_jax(kind):
    rs = _rs(1)
    shape = (3, 4)
    init = rs.randn(*shape).astype("f")
    pushes = [[rs.randn(*shape).astype("f") for _ in range(3)]
              for _ in range(2)]
    res = {}
    for pkg, arr in ((jmx, jnd.array), (mx, _t)):
        kv = pkg.kv.create(kind)
        kv.init([5, "w"], [arr(init), arr(init * 2)])
        for vals in pushes:
            kv.push(5, [arr(v) for v in vals])
            kv.push("w", arr(vals[0]))
        res[pkg] = (_pull(kv, 5, shape, pkg), _pull(kv, "w", shape, pkg))
        assert (kv.rank, kv.num_workers) == (0, 1)
    for a, b in zip(res[mx], res[jmx]):
        _close(a, b)
    # no updater: the store sums every push into its value
    _close(res[mx][0], init + sum(sum(p) for p in pushes), 1e-5)


@pytest.mark.parametrize("with_optimizer", [True, False])
def test_set_optimizer_updater_and_pushpull_match_jax(with_optimizer):
    rs = _rs(2)
    shape = (6,)
    init = rs.randn(*shape).astype("f")
    grads = [rs.randn(*shape).astype("f") for _ in range(4)]
    res = {}
    for pkg, arr in ((jmx, jnd.array), (mx, _t)):
        kv = pkg.kv.create("local")
        kv.init(0, arr(init))
        if with_optimizer:
            kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1,
                                               momentum=0.9, wd=0.01))
        else:
            def updater(key, grad, weight, pkg=pkg):
                weight[:] = weight - 0.5 * grad
            kv.set_updater(updater)
        out = pkg.nd.zeros(shape, ctx=CPU) if pkg is mx \
            else pkg.nd.zeros(shape)
        seen = []
        for g in grads:
            kv.pushpull(0, arr(g), out=out)
            seen.append(out.asnumpy().copy())
        res[pkg] = seen
    for a, b in zip(res[mx], res[jmx]):
        _close(a, b)


def test_async_applier_matches_jax_and_reads_its_writes():
    rs = _rs(3)
    grads = [rs.randn(4).astype("f") for _ in range(6)]
    res = {}
    for pkg, arr in ((jmx, jnd.array), (mx, _t)):
        kv = pkg.kv.create("dist_async")
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.05, momentum=0.5))
        kv.init("a", arr(onp.ones(4, "f")))
        for g in grads:
            kv.push("a", arr(g))
        res[pkg] = _pull(kv, "a", (4,), pkg)  # waits for every push
        kv.barrier()
    _close(res[mx], res[jmx])
    assert mx.kv.create("dist_async")._async_mode


def test_async_applier_failure_is_raised_at_the_next_pull():
    kv = mx.kv.create("dist_async")
    kv.init(0, _t(onp.zeros(2, "f")))

    def bad(key, grad, weight):
        raise ValueError("boom")

    kv.set_updater(bad)
    kv.push(0, _t(onp.ones(2, "f")))
    with pytest.raises(mx.MXNetError, match="boom"):
        kv.pull(0, out=nd.zeros((2,), ctx=CPU))


def test_kvstore_async_knob_counts_pushes(monkeypatch):
    from mxnet_tpu_torch import pipeline

    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "1")
    pipeline.reset_pipeline_counters()
    kv = mx.kv.create("local")
    assert kv._async_mode and kv._pipeline_async
    kv.init(0, _t(onp.zeros(3, "f")))
    for _ in range(3):
        kv.push(0, _t(onp.ones(3, "f")))
    _close(_pull(kv, 0, (3,), mx), onp.full(3, 3.0, "f"))
    assert pipeline.pipeline_counters()["kvstore_async_pushes"] == 3


def test_save_and_load_optimizer_states_match_jax(tmp_path):
    rs = _rs(4)
    grads = [rs.randn(5).astype("f") for _ in range(4)]
    res = {}
    for pkg, arr in ((jmx, jnd.array), (mx, _t)):
        kv = pkg.kv.create("local")
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        kv.init(1, arr(onp.ones(5, "f")))
        for g in grads[:2]:
            kv.push(1, arr(g))
        fname = str(tmp_path / f"{pkg.__name__}.states")
        kv.save_optimizer_states(fname)
        for g in grads[2:]:
            kv.push(1, arr(g))
        res[pkg] = _pull(kv, 1, (5,), pkg)
        # the momentum comes back as it was after the first two pushes
        kv.load_optimizer_states(fname)
        mom = kv._updater.states[1]
        res[pkg, "mom"] = (mom.asnumpy() if hasattr(mom, "asnumpy")
                           else onp.asarray(mom))
    _close(res[mx], res[jmx])
    _close(res[mx, "mom"], res[jmx, "mom"])


def test_unknown_store_and_uninitialized_key_raise():
    with pytest.raises(mx.MXNetError, match="unknown kvstore"):
        mx.kv.create("dist_ring")
    kv = mx.kv.create("local")
    with pytest.raises(mx.MXNetError, match="not initialized"):
        kv.push("missing", _t(onp.zeros(1, "f")))
    with pytest.raises(mx.MXNetError, match="no optimizer"):
        kv.save_optimizer_states("unused")


def test_gc_knobs_turn_compression_on(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_GC_TYPE", "2bit")
    monkeypatch.setenv("MXNET_KVSTORE_GC_THRESHOLD", "0.25")
    kv = mx.kv.create("device")
    assert kv._compression.params() == {"type": "2bit", "threshold": 0.25}


# -- 2-bit compression --------------------------------------------------------

@pytest.mark.parametrize("n,threshold", [(1, 0.5), (15, 0.3), (16, 0.5),
                                         (17, 0.1), (37, 0.4), (1000, 0.05)])
def test_2bit_words_equal_jax_and_residuals_agree(n, threshold):
    import jax.numpy as jnp

    rs = _rs(n)
    jgc, tgc = JGradientCompression("2bit", threshold), \
        GradientCompression("2bit", threshold)
    jres, tres = jnp.zeros(n, jnp.float32), torch.zeros(n)
    for _ in range(3):  # the residual carries across steps
        g = ((rs.rand(n) - 0.5) * 4 * threshold).astype("f")
        jp, jres = jgc.quantize(jnp.asarray(g), jres)
        tp, tres = tgc.quantize(torch.from_numpy(g), tres)
        assert tp.dtype == torch.int32 and tp.shape == (-(-n // 16),)
        onp.testing.assert_array_equal(tp.numpy().view("uint32"),
                                       onp.asarray(jp))
        onp.testing.assert_allclose(tres.numpy(), onp.asarray(jres),
                                    rtol=0, atol=1e-7)
        onp.testing.assert_array_equal(
            tgc.dequantize(tp, n).numpy(),
            onp.asarray(jgc.dequantize(jp, n)))


def test_compression_rejects_unknown_type_and_bad_threshold():
    kv = mx.kv.create("device")
    with pytest.raises(mx.MXNetError):
        kv.set_gradient_compression({"type": "1bit"})
    with pytest.raises(mx.MXNetError):
        GradientCompression("2bit", threshold=0)
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    assert kv._compression.get_compression_factor() == 16
    kv.set_gradient_compression({"type": "none"})
    assert kv._compression is None


def test_compressed_push_matches_jax():
    """As ``tests/test_multidevice.py``'s compressed push: four sources
    with their residuals, twice, on one device (summed serially)."""
    rs = _rs(5)
    shape = (24,)
    grads = [(rs.rand(*shape).astype("f") - 0.5) for _ in range(4)]
    res = {}
    for pkg, arr in ((jmx, jnd.array), (mx, _t)):
        kv = pkg.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.3})
        kv.init("w", arr(onp.zeros(shape, "f")))
        outs = []
        for _ in range(2):
            kv.push("w", [arr(g) for g in grads])
            outs.append(_pull(kv, "w", shape, pkg))
        res[pkg] = outs
    for a, b in zip(res[mx], res[jmx]):
        _close(a, b)


# -- collectives -------------------------------------------------------------

def test_collectives_outside_a_group():
    x = _t(_rs(6).randn(3).astype("f"))
    assert parallel.all_reduce(x) is x
    vals = [x, _t(onp.ones(2, "f"))]
    assert parallel.all_reduce_coalesced(vals) == vals
    assert parallel.device_count() >= 1
    with pytest.raises(mx.MXNetError, match="9b"):
        parallel.all_reduce(x, axis_name="dp")
    # values that share a device: the kvstore then sums serially
    with pytest.raises(mx.MXNetError, match="distinct device"):
        parallel.group_all_reduce([x, x])
    assert parallel.group_all_reduce([x]) == [x]


def test_coalesced_reduce_is_one_collective_per_dtype_and_bitwise():
    rs = _rs(7)
    vals = [torch.from_numpy(rs.randn(*s).astype("f"))
            for s in ((3, 2), (5,), (1, 4))]
    vals.insert(1, torch.arange(6, dtype=torch.float64).reshape(2, 3))
    calls = []

    def double(flat):
        calls.append((flat.dtype, flat.numel()))
        return flat * 2

    out = parallel.all_reduce_coalesced(vals, reduce_fn=double)
    assert sorted(calls, key=str) == sorted(
        [(torch.float32, 6 + 5 + 4), (torch.float64, 6)], key=str)
    for v, o in zip(vals, out):
        assert o.shape == v.shape and torch.equal(o, v * 2)


# -- the retry policy ----------------------------------------------------------

def test_retry_backoff_sequence_matches_jax():
    j = JRetryPolicy(max_attempts=6, base_ms=10, max_ms=50, jitter=0.5,
                     seed=3)
    t = RetryPolicy(max_attempts=6, base_ms=10, max_ms=50, jitter=0.5,
                    seed=3)
    assert [t.delay_ms(k) for k in range(1, 6)] == \
        [j.delay_ms(k) for k in range(1, 6)]


def test_retry_runs_until_success_or_exhausted(monkeypatch):
    from mxnet_tpu_torch.resilience import retry

    retry.reset_retry_counters()
    sleeps = []
    policy = RetryPolicy(max_attempts=3, base_ms=1, jitter=0,
                         sleep=sleeps.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert policy.run(flaky) == "ok" and sleeps == [0.001, 0.002]
    assert retry.retry_counters()["retry_attempts"] == 2
    with pytest.raises(RetryExhausted) as e:
        policy.run(lambda: (_ for _ in ()).throw(OSError("down")))
    assert e.value.attempts == 3
    with pytest.raises(KeyError):  # not transient: at once
        RetryPolicy(retry_on=OSError).run(
            lambda: (_ for _ in ()).throw(KeyError("k")))
    monkeypatch.setenv("MXNET_RESILIENCE", "0")
    calls.clear()
    with pytest.raises(RetryExhausted) as e:
        policy.run(lambda: calls.append(1) or (_ for _ in ()).throw(
            OSError("x")))
    assert e.value.attempts == 1 and calls == [1]


# -- the rendezvous -------------------------------------------------------------

def test_backend_rule():
    assert launch.choose_backend(2, True, 0) == "gloo"   # the CPU
    assert launch.choose_backend(2, False, 1) == "gloo"  # two ranks, 1 card
    assert launch.choose_backend(1, False, 1) == "nccl"
    assert launch.choose_backend(8, False, 8) == "nccl"


def test_rendezvous_without_a_rank_or_a_card_raises(monkeypatch):
    monkeypatch.setenv("MXNET_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("MXNET_PROCESS_ID", raising=False)
    monkeypatch.setenv("MXNET_NUM_PROCESSES", "2")
    with pytest.raises(mx.MXNetError, match="guessed rank"):
        _rendezvous.init()
    monkeypatch.setenv("MXNET_PROCESS_ID", "0")
    if not torch.cuda.is_available():
        # no silent move to the CPU: a rank that does not ask for it
        # needs a card
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            _rendezvous.init()
    assert not launch.is_initialized() and launch.backend() is None
    monkeypatch.delenv("MXNET_COORDINATOR")
    assert _rendezvous.init() is False


def test_server_roles_exit_at_import():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch.kvstore_server\n"
         "print('trained')"], capture_output=True, text=True, timeout=120,
        env=dict(__import__("os").environ, DMLC_ROLE="server"))
    assert out.returncode == 0 and "trained" not in out.stdout


# -- the grad-ready hook and the bucketed reducer ------------------------------

def _mlp(seed=8):
    rs = _rs(seed)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, in_units=6, activation="relu"),
            gluon.nn.Dense(3, in_units=16))
    net.initialize(ctx=CPU)
    for p in net.collect_params().values():
        p.set_data(rs.randn(*p.shape).astype("f") * 0.5)
    return net


def _backward(net, seed):
    rs = _rs(seed)
    x, y = _t(rs.randn(4, 6).astype("f")), _t(rs.randn(4, 3).astype("f"))
    with autograd.record():
        loss = gluon.loss.L2Loss()(net(x), y)
    loss.backward()


def test_grad_ready_hook_fires_once_per_written_gradient():
    net = _mlp()
    seen = []
    remove = autograd.register_grad_ready_hook(seen.append)
    try:
        _backward(net, 1)
    finally:
        remove()
    remove()  # idempotent
    params = list(net.collect_params().values())
    assert sorted(map(id, seen)) == sorted(id(p._ndarray) for p in params)
    for arr in seen:
        assert arr._grad is not None
    _backward(net, 2)
    assert len(seen) == len(params)


@pytest.mark.parametrize("bucket_bytes", [1, 200, 1 << 20])
def test_reducer_sums_bitwise_as_the_step_time_reduce(bucket_bytes):
    """``reduce_fn`` doubles (two ranks holding the same gradient): the
    reducer's speculative sums equal one coalesced reduce at the step,
    bitwise, whatever the buckets; the buckets follow parameter order."""
    from mxnet_tpu_torch import pipeline

    def double(flat):
        order.append(flat.numel())
        return flat * 2

    net = _mlp()
    params = list(net.collect_params().values())
    order = []
    red = AsyncGradReducer(params, bucket_bytes=bucket_bytes,
                           reduce_fn=double).attach()
    pipeline.reset_pipeline_counters()
    try:
        red._round_enabled = True
        red._refresh_index()
        _backward(net, 3)
        grads = [p.grad() for p in params]
        want = [g.data * 2 for g in grads]
        in_backward = pipeline.pipeline_counters()["grad_buckets"]
        assert red.flush(grads) == 0
    finally:
        red.detach()
    for g, w in zip(grads, want):
        assert torch.equal(g.data, w)
    sizes = [p.grad().data.numel() for p in params]
    if bucket_bytes == 1:
        assert order == sizes and in_backward == len(params)
    elif bucket_bytes == 1 << 20:
        assert order == [sum(sizes)] and in_backward == 0


def test_reducer_reduces_again_a_gradient_written_after_dispatch():
    net = _mlp()
    params = list(net.collect_params().values())
    for p in params:
        p.grad_req = "add"
    red = AsyncGradReducer(params, bucket_bytes=1,
                           reduce_fn=lambda f: f * 2).attach()
    from mxnet_tpu_torch import pipeline

    try:
        red._round_enabled = True
        red._refresh_index()
        _backward(net, 4)
        _backward(net, 5)  # accumulates after the first dispatch
        grads = [p.grad() for p in params]
        want = [g.data * 2 for g in grads]
        pipeline.reset_pipeline_counters()
        assert red.flush(grads) == len(params)
        assert pipeline.pipeline_counters()["grad_stale_discards"] == \
            len(params)
    finally:
        red.detach()
    for g, w in zip(grads, want):
        assert torch.equal(g.data, w)


def test_trainer_with_the_reducer_on_and_off_steps_alike(monkeypatch):
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_ASYNC_GRAD_SYNC", flag)
        net = _mlp()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="dist_sync")
        for i in range(3):
            _backward(net, 10 + i)
            tr.step(4)
        assert (tr._grad_reducer is not None) == (flag == "1")
        runs.append([p.data().asnumpy() for p in
                     net.collect_params().values()])
    for a, b in zip(*runs):
        onp.testing.assert_array_equal(a, b)


def test_trainer_save_states_abandons_speculation(tmp_path):
    net = _mlp()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync")
    _backward(net, 6)
    tr.step(4)  # makes and hooks the reducer
    _backward(net, 7)
    assert tr._grad_reducer._pending  # one partial bucket, not yet sent
    tr.save_states(str(tmp_path / "s"))
    assert not tr._grad_reducer._spec and not tr._grad_reducer._pending
    tr.load_states(str(tmp_path / "s"))


def test_trainer_compression_quantizes_before_the_sum():
    """A one-process dist_sync Trainer with 2-bit compression updates
    with the quantized gradient and keeps the residual (SGD, no
    momentum: w - lr * q / batch)."""
    net = _mlp()
    params = list(net.collect_params().values())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync",
                       compression_params={"type": "2bit", "threshold": 0.5})
    gc = GradientCompression("2bit", 0.5)
    res = [None] * len(params)
    for step in range(2):
        w0 = [p.data().data.clone() for p in params]
        _backward(net, 20 + step)
        grads = [p.grad().data.clone() for p in params]
        tr.step(4)
        for i, (p, g) in enumerate(zip(params, grads)):
            q, res[i] = gc.roundtrip(g, res[i])
            assert torch.equal(tr._residuals[i], res[i])
            torch.testing.assert_close(p.data().data, w0[i] - 0.1 * q / 4,
                                       rtol=0, atol=1e-7)
