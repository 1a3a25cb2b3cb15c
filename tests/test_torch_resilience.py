"""The resilience layer's checkpoints in the port: ``CheckpointManager``,
``AutoResume``, ``DeviceFeed``'s cursor, on the CPU.

Where the port runs beside the JAX package (``AutoResume``'s trace and
counters, the disk discipline, the feed's cursor) the weights are carried
across with ``convert.params_from_numpy`` and dropout is off (Threefry
and Philox never agree); values agree within rtol 1e-5 / atol 1e-6 (as
``test_torch_dist_sync.py``) and counters and step lists exactly. The
port's own properties are bitwise, with dropout on: a crashed-and-resumed
run, a SIGKILLed process resumed by another, an AMP skip episode.

The deliberate differences from the JAX package are pinned here too: the
salt names torch's version and the state's device type; an asynchronous
capture copies the state on the device (the JAX capture holds references
to immutable arrays); a restore writes every parameter and state in
place.

Run as a script (``python tests/test_torch_resilience.py``) this file is
the SIGKILL test's child process: it trains under ``AutoResume`` as the
``RESIL_*`` variables say.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as onp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, convert, gluon, nd  # noqa: E402
from mxnet_tpu_torch import random as _random  # noqa: E402
from mxnet_tpu_torch import resilience  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.contrib.amp.loss_scaler import LossScaler  # noqa: E402
from mxnet_tpu_torch.gluon import fused_step, nn  # noqa: E402
from mxnet_tpu_torch.resilience import (  # noqa: E402
    AutoResume, CheckpointManager, InjectedFault, ResumeExhausted, faults)
from mxnet_tpu_torch.resilience import checkpoint as ckpt_mod  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
DIM, OUT, BATCH = 8, 4, 4
CPU = mx.cpu()


def _jax():
    """The JAX package, imported only by the tests that compare with it
    (the child process never imports JAX)."""
    import mxnet_tpu as jmx
    from mxnet_tpu import resilience as jres

    return jmx, jres


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    resilience.reset_resilience_counters()
    yield
    faults.disarm()
    resilience.reset_resilience_counters()


def _net(seed=3, p=0.5):
    mx.random.seed(seed)
    net = nn.Sequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dropout(p), nn.Dense(OUT))
    net.initialize(ctx=CPU)
    net(nd.zeros((1, DIM), ctx=CPU))
    return net


def _trainer(net, optimizer="sgd", scaler=False):
    kw = {"learning_rate": 0.05}
    if optimizer == "sgd":
        kw["momentum"] = 0.9
    tr = gluon.Trainer(net.collect_params(), optimizer, kw)
    if scaler:
        tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 8, scale_window=3)
    return tr


def _batch(x, y):
    return nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)


def _step(net, tr, x, y):
    x, y = _batch(x, y)
    with autograd.record():
        loss = ((net(x) - y) ** 2).mean()
    loss.backward()
    tr.step(BATCH)
    return float(loss.asscalar())


def _train(net, tr, n, seed, poison_at=None):
    rs = onp.random.RandomState(seed)
    for s in range(n):
        x = rs.rand(BATCH, DIM).astype("f")
        y = rs.rand(BATCH, OUT).astype("f")
        if s == poison_at:
            x = onp.full_like(x, onp.inf)
        _step(net, tr, x, y)


def _pbytes(net):
    return [p.data().asnumpy().tobytes()
            for p in net.collect_params().values()]


def _sbytes(tr):
    out = []
    for s in tr._states:
        for leaf in (s if isinstance(s, tuple) else (s,)):
            if leaf is not None:
                out.append(leaf.asnumpy().tobytes())
    return out


def _gen_state():
    st = _random._capture_state()
    return st["seed"], {k: v.tobytes() for k, v in st["generators"].items()}


# -- the manager ----------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_round_trip_bitwise(tmp_path, async_mode, optimizer):
    """Save, train on, restore: parameters, optimizer states, counters and
    the generator are bitwise what was saved, and training on from the
    restore repeats the first continuation bit for bit (momentum or the
    moments, dropout masks, counters)."""
    net = _net()
    tr = _trainer(net, optimizer)
    _train(net, tr, 3, seed=1)
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=async_mode)
    mgr.save(3, cursor={"epoch": 0, "step_in_epoch": 3})
    mgr.wait()
    saved = (_pbytes(net), _sbytes(tr), tr._optimizer.num_update,
             dict(tr._optimizer._index_update_count), _gen_state())
    _train(net, tr, 3, seed=2)
    after = _pbytes(net)
    meta = mgr.restore()
    assert meta["step"] == 3 and meta["cursor"]["step_in_epoch"] == 3
    assert (_pbytes(net), _sbytes(tr), tr._optimizer.num_update,
            dict(tr._optimizer._index_update_count), _gen_state()) == saved
    _train(net, tr, 3, seed=2)
    assert _pbytes(net) == after
    c = resilience.resilience_counters()
    assert c["ckpt_restores"] == 1 and c["ckpt_saves"] == 1
    assert c["ckpt_async_saves"] == (1 if async_mode else 0)


def test_amp_scaler_and_skip_count_round_trip(tmp_path):
    """The loss scale, the window position and the fused step's skip count
    survive the round trip, through a real overflow."""
    net = _net(p=0.0)
    tr = _trainer(net, scaler=True)
    _train(net, tr, 4, seed=3, poison_at=1)
    scale = tr._amp_loss_scaler.loss_scale
    num_update = tr._optimizer.num_update
    skips = tr._fused_skipped_steps()
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=True)
    mgr.save(4)
    _train(net, tr, 2, seed=4, poison_at=0)
    mgr.restore()
    assert tr._amp_loss_scaler.loss_scale == scale == 2.0 ** 7
    assert tr._optimizer.num_update == num_update == 3
    assert tr._fused_skipped_steps() == skips == 1


def test_random_stream_round_trip(tmp_path):
    mx.random.seed(9)
    mx.nd.random.uniform(shape=(2,), ctx=CPU)
    mgr = CheckpointManager(str(tmp_path), async_mode=False)
    mgr.save(1)
    expect = mx.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy()
    mx.nd.random.uniform(shape=(4,), ctx=CPU)
    mx.random.seed(10)  # the seed comes back too
    mgr.restore()
    assert _random._SEED[0] == 9
    onp.testing.assert_array_equal(
        mx.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy(), expect)


def test_store_values_and_updater_states_round_trip(tmp_path):
    kv = mx.kvstore.create("local")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                         momentum=0.9))
    kv.init("w", nd.array(onp.arange(4, dtype="f"), ctx=CPU))
    kv.push("w", nd.ones((4,), ctx=CPU))
    mgr = CheckpointManager(str(tmp_path), kvstore=kv, async_mode=True)
    mgr.save(1)
    mgr.wait()
    want = nd.zeros((4,), ctx=CPU)
    kv.pull("w", out=want)
    states = kv._updater.get_states()
    kv.push("w", nd.ones((4,), ctx=CPU) * 3)
    stored = kv._store["w"].data
    mgr.restore()
    assert kv._store["w"].data is stored  # in place
    got = nd.zeros((4,), ctx=CPU)
    kv.pull("w", out=got)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert kv._updater.get_states() == states
    # the next push moves both runs alike (momentum restored)
    kv.push("w", nd.ones((4,), ctx=CPU))
    kv.pull("w", out=got)
    ref = want.asnumpy() - 0.1 * (1.0 + 0.9 * 1.0)
    onp.testing.assert_allclose(got.asnumpy(), ref, rtol=RTOL, atol=ATOL)


def test_store_round_trip_matches_jax(tmp_path):
    """The JAX package's store round trip (``test_resilience.py:516``):
    both packages hand back the initial values after a push."""
    jmx, _ = _jax()
    from mxnet_tpu.resilience import CheckpointManager as JManager

    init = onp.arange(4, dtype="f")
    jkv = jmx.kvstore.create("local")
    jkv.init("w", jmx.nd.array(init))
    jmgr = JManager(str(tmp_path / "jax"), kvstore=jkv, async_mode=False)
    jmgr.save(1)
    jkv.push("w", jmx.nd.ones((4,)))
    jmgr.restore()
    jout = jmx.nd.zeros((4,))
    jkv.pull("w", out=jout)
    kv = mx.kvstore.create("local")
    kv.init("w", nd.array(init, ctx=CPU))
    mgr = CheckpointManager(str(tmp_path / "port"), kvstore=kv,
                            async_mode=False)
    mgr.save(1)
    kv.push("w", nd.ones((4,), ctx=CPU))
    mgr.restore()
    out = nd.zeros((4,), ctx=CPU)
    kv.pull("w", out=out)
    onp.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    onp.testing.assert_array_equal(out.asnumpy(), init)


def test_restore_writes_in_place_and_keeps_the_fused_step(tmp_path):
    """Every restored parameter and state lands in its own storage, so
    a captured step (and a hybridized block's graphs) keeps reading
    them: same pointers, the same fused-step entry, no rebuild, and the
    next step equals the uninterrupted run's."""
    fused_step.reset_fused_step_cache()
    net = _net()
    tr = _trainer(net, "adam", scaler=True)
    _train(net, tr, 2, seed=5)
    params = list(net.collect_params().values())
    ptrs = [p.data().data.data_ptr() for p in params]
    sptrs = [leaf.data.data_ptr() for s in tr._states for leaf in s]
    cache = tr._fused
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=True)
    mgr.save(2)
    _train(net, tr, 1, seed=6)
    want = _pbytes(net)
    _train(net, tr, 2, seed=7)
    mgr.restore()
    assert [p.data().data.data_ptr() for p in params] == ptrs
    assert [leaf.data.data_ptr() for s in tr._states for leaf in s] == sptrs
    _train(net, tr, 1, seed=6)
    assert tr._fused is cache
    assert fused_step.fused_step_stats()["misses"] == 1
    assert _pbytes(net) == want


def test_async_capture_copies_on_the_device(tmp_path, monkeypatch):
    """The port's capture copies every leaf when ``save`` returns (its
    tensors are written in place by the next steps, where the JAX
    capture could hold references to immutable arrays): steps taken
    while the write is held back do not reach the checkpoint."""
    gate = threading.Event()
    real = CheckpointManager._write

    def held(self, job):
        gate.wait(10)
        real(self, job)

    monkeypatch.setattr(CheckpointManager, "_write", held)
    net = _net()
    tr = _trainer(net, "adam")
    _train(net, tr, 2, seed=1)
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=True)
    t0 = time.perf_counter()
    mgr.save(2)
    assert time.perf_counter() - t0 < 1.0  # did not wait for the write
    assert mgr.latest_valid() is None  # still in flight
    saved = (_pbytes(net), _sbytes(tr))
    _train(net, tr, 3, seed=2)
    assert _pbytes(net) != saved[0]
    gate.set()
    mgr.wait()
    mgr.restore()
    assert (_pbytes(net), _sbytes(tr)) == saved


def test_bfloat16_leaves_bit_for_bit(tmp_path):
    """bfloat16 parameters and states reach the disk as their bits (numpy
    has no bfloat16) and come back unchanged, NaN payloads included."""
    import torch

    net = _net(p=0.0)
    net.cast("bfloat16")
    tr = _trainer(net, "sgd")
    tr._optimizer.multi_precision = True
    params = list(net.collect_params().values())
    rs = onp.random.RandomState(0)
    for p in params:
        bits = rs.randint(-2 ** 15, 2 ** 15, size=p.shape).astype("int16")
        bits.flat[0] = 0x7FC1  # a NaN with a payload
        with torch.no_grad():
            p.data().data.copy_(torch.from_numpy(bits).view(torch.bfloat16))
    want = [p.data().data.view(torch.int16).clone() for p in params]
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=True)
    mgr.save(1)
    mgr.wait()
    with torch.no_grad():
        for p in params:
            p.data().data.fill_(1.0)
    mgr.restore()
    for p, w in zip(params, want):
        assert p.data().data.dtype == torch.bfloat16
        assert torch.equal(p.data().data.view(torch.int16), w)


def test_restore_onto_a_mismatched_network_names_the_parameter(tmp_path):
    net = _net()
    tr = _trainer(net)
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=False)
    mgr.save(1)
    mx.random.seed(3)
    other = nn.Sequential()
    other.add(nn.Dense(16, activation="relu"), nn.Dropout(0.5),
              nn.Dense(OUT + 1))
    other.initialize(ctx=CPU)
    other(nd.zeros((1, DIM), ctx=CPU))
    # the same names, another head: give the new network the old names
    for new, old in zip(other.collect_params().values(),
                        net.collect_params().values()):
        new.name = old.name
    mgr2 = CheckpointManager(str(tmp_path), params=list(
        other.collect_params().values()), async_mode=False)
    head = list(other.collect_params().values())[-2]
    with pytest.raises(MXNetError, match=head.name):
        mgr2.restore()
    stranger = CheckpointManager(str(tmp_path), params=list(
        _net(seed=4).collect_params().values())[:1], async_mode=False)
    with pytest.raises(MXNetError, match="not present"):
        stranger.restore()


def test_a_checkpoint_of_another_device_type_is_refused(tmp_path,
                                                        monkeypatch):
    """The salt holds the state's device type: a checkpoint made on the
    card does not validate on the CPU, so nothing restores it there."""
    net = _net()
    tr = _trainer(net)
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=False)
    monkeypatch.setattr(CheckpointManager, "_device_type",
                        lambda self: "cuda")
    mgr.save(1)
    with open(tmp_path / "ckpt-000000000001" / "manifest.json") as f:
        salt = json.load(f)["salt"]
    import torch

    assert salt == [ckpt_mod.FORMAT_VERSION, mx.__version__,
                    torch.__version__, "cuda"]
    assert mgr.validate(1)
    monkeypatch.undo()
    assert not mgr.validate(1)
    with pytest.raises(MXNetError, match="no valid checkpoint"):
        mgr.restore()
    assert resilience.resilience_counters()["ckpt_corrupt_skipped"] == 1


# -- the disk discipline, in both packages --------------------------------

def _jax_net_and_trainer(seed=3, p=0.0):
    jmx, _ = _jax()
    jmx.random.seed(seed)
    net = jmx.gluon.nn.Sequential()
    net.add(jmx.gluon.nn.Dense(16, activation="relu"),
            jmx.gluon.nn.Dropout(p), jmx.gluon.nn.Dense(OUT))
    net.initialize()
    net(jmx.nd.zeros((1, DIM)))
    tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9})
    return net, tr


def _carried(jnet, p=0.0):
    """The port's MLP holding the JAX MLP's weights."""
    net = _net(p=p)
    arrays = {k: v.data().asnumpy()
              for k, v in jnet._collect_params_with_prefix().items()}
    return convert.params_from_numpy(net, arrays, ctx=CPU)


def _both_managers(tmp_path, **kw):
    from mxnet_tpu.resilience import CheckpointManager as JManager

    jnet, jtr = _jax_net_and_trainer()
    net = _carried(jnet)
    tr = _trainer(net)
    return (JManager(str(tmp_path / "jax"), trainer=jtr, **kw),
            CheckpointManager(str(tmp_path / "port"), trainer=tr, **kw))


def test_disk_discipline_matches_jax(tmp_path):
    """The same saves in both packages: the same steps stay after
    pruning, the manifests have the same keys, no ``.tmp-*`` is left, and
    a flipped byte in the newest payload makes both fall back to the
    step before with one ``ckpt_corrupt_skipped``."""
    _, jres = _jax()
    jres.reset_resilience_counters()
    mgrs = _both_managers(tmp_path, keep=2, async_mode=True)
    for mgr in mgrs:
        for s in (1, 2, 3, 5):
            mgr.save(s, cursor={"epoch": 0, "step_in_epoch": s})
        mgr.wait()
    jm, pm = mgrs
    assert jm.list_steps() == pm.list_steps() == [3, 5]
    for mgr in mgrs:
        names = sorted(os.listdir(mgr.directory))
        assert names == ["ckpt-000000000003", "ckpt-000000000005"]
    keys = []
    for mgr in mgrs:
        with open(os.path.join(mgr._dir_for(5), "manifest.json")) as f:
            man = json.load(f)
        keys.append((sorted(man), sorted(man["files"]),
                     sorted(man["files"]["state.pkl"]), man["step"],
                     man["cursor"]))
    assert keys[0] == keys[1]
    assert keys[1][0] == ["cursor", "files", "format", "salt", "step"]
    jc, pc = jres.resilience_counters(), resilience.resilience_counters()
    for k in ("ckpt_saves", "ckpt_async_saves", "ckpt_pruned"):
        assert jc[k] == pc[k], k
    for mgr in mgrs:
        path = os.path.join(mgr._dir_for(5), "state.pkl")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        assert mgr.latest_valid() == 3
        assert mgr.restore()["step"] == 3
    assert jres.resilience_counters()["ckpt_corrupt_skipped"] == \
        resilience.resilience_counters()["ckpt_corrupt_skipped"] == 2


def test_changed_salt_invalidates_in_both(tmp_path, monkeypatch):
    from mxnet_tpu.resilience import checkpoint as jckpt

    jm, pm = _both_managers(tmp_path, async_mode=False)
    for mgr in (jm, pm):
        mgr.save(1)
        assert mgr.validate(1)
    monkeypatch.setattr(jckpt, "_salt", lambda: ["other-version"])
    monkeypatch.setattr(ckpt_mod, "_salt", lambda dev: ["other-version"])
    assert not jm.validate(1) and not pm.validate(1)
    assert jm.latest_valid() is None and pm.latest_valid() is None


def test_a_torn_write_leaves_only_tmp_and_the_next_manager_cleans(
        tmp_path):
    """A write killed mid-way leaves a ``.tmp-*`` directory only: loads
    never see it, and the next manager over the directory deletes it, as
    in the JAX package."""
    from mxnet_tpu.resilience import CheckpointManager as JManager

    jm, pm = _both_managers(tmp_path, async_mode=False)
    for mgr in (jm, pm):
        mgr.save(1)
        torn = os.path.join(mgr.directory, ".tmp-ckpt-2-1-1")
        os.makedirs(torn)
        open(os.path.join(torn, "state.pkl"), "wb").write(b"\x80half")
        assert mgr.latest_valid() == 1
    JManager(jm.directory)
    CheckpointManager(pm.directory)
    for mgr in (jm, pm):
        assert sorted(os.listdir(mgr.directory)) == ["ckpt-000000000001"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_write_fault_surfaces_at_the_next_wait(tmp_path, package):
    """``checkpoint_write`` fires on the writer thread; the failure is
    raised by the next ``wait`` (never dropped), nothing becomes visible,
    and the next save succeeds."""
    if package == "jax":
        _, jres = _jax()
        from mxnet_tpu.resilience import CheckpointManager as Manager
        jfaults = jres.faults
        arm = lambda: jfaults.arm("checkpoint_write:at=1")  # noqa: E731
        disarm, err = jfaults.disarm, _jax()[0].base.MXNetError
    else:
        Manager, err = CheckpointManager, MXNetError
        ctx = faults.inject("checkpoint_write", at=1)
        arm, disarm = ctx.__enter__, lambda: ctx.__exit__(None, None, None)
    mgr = Manager(str(tmp_path), async_mode=True)
    arm()
    mgr.save(1)
    with pytest.raises(err, match="background checkpoint write failed"):
        mgr.wait()
    disarm()
    assert mgr.list_steps() == []
    assert [n for n in os.listdir(tmp_path) if n.startswith(".tmp")] == []
    mgr.save(2)
    mgr.wait()
    assert mgr.latest_valid() == 2


def test_write_fault_surfaces_at_the_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_mode=True)
    with faults.inject("checkpoint_write", at=1):
        mgr.save(1)
        mgr._q.join()
    with pytest.raises(MXNetError, match="injected fault"):
        mgr.save(2)
    mgr.save(3)
    mgr.wait()
    assert mgr.list_steps() == [3]


def test_retention_keeps_last_n_and_zero_keeps_all(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"), keep=2, async_mode=False)
    for s in range(1, 5):
        mgr.save(s)
    assert mgr.list_steps() == [3, 4]
    assert resilience.resilience_counters()["ckpt_pruned"] == 2
    mgr = CheckpointManager(str(tmp_path / "b"), keep=0, async_mode=False)
    for s in range(1, 5):
        mgr.save(s)
    assert mgr.list_steps() == [1, 2, 3, 4]


def test_knobs_give_the_defaults(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("MXNET_CKPT_KEEP", "5")
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    mgr = CheckpointManager()
    assert mgr.directory == str(tmp_path / "env")
    assert (mgr.keep, mgr.async_mode) == (5, False)
    monkeypatch.delenv("MXNET_CKPT_DIR")
    monkeypatch.setenv("MXNET_HOME", str(tmp_path / "home"))
    assert CheckpointManager().directory == str(
        tmp_path / "home" / "checkpoints")


def test_write_and_restore_spans_and_surfaces(tmp_path, monkeypatch):
    from mxnet_tpu_torch import profiler, runtime, telemetry

    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    telemetry.tracer.reset()
    mgr = CheckpointManager(str(tmp_path), async_mode=True)
    mgr.save(7)
    mgr.wait()
    mgr.restore()
    names = {e["name"] for e in telemetry.tracer.events()}
    assert {"checkpoint.write", "checkpoint.restore"} <= names
    c = profiler.resilience_counters()
    assert c["ckpt_saves"] == 1 and c["ckpt_restores"] == 1
    assert c["ckpt_bytes"] > 0 and c["ckpt_write_s"] > 0
    assert runtime.Features().is_enabled("RESILIENCE")
    fname = str(tmp_path / "prof.json")
    profiler.set_config(filename=fname)
    try:
        with open(profiler.dump()) as f:
            events = json.load(f)["traceEvents"]
        assert any(e["name"] == "resilience/ckpt_saves" for e in events)
    finally:
        profiler.set_config(filename="profile.json")


# -- AutoResume -------------------------------------------------------------

def _data(epoch, steps=6, poison=None):
    rs = onp.random.RandomState(500 + epoch)
    for s in range(steps):
        x = rs.rand(BATCH, DIM).astype("f")
        y = rs.rand(BATCH, OUT).astype("f")
        if (epoch, s) == poison:
            x = onp.full_like(x, onp.inf)
        yield x, y


def _faulty(step_fn, fault_at, exc):
    """``step_fn`` raising ``exc`` once, at its call of global step
    ``fault_at`` (None: never)."""
    calls = {"n": 0}

    def run(batch):
        calls["n"] += 1
        if fault_at is not None and calls["n"] == fault_at + 1:
            raise exc(f"injected fault at step {fault_at}")
        return step_fn(batch)

    return run


def _port_job(tmp_path, net, tr, fault_at=None, poison=None, **kw):
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=True,
                            keep=3)
    sup = AutoResume(mgr, lambda e: _data(e, poison=poison),
                     _faulty(lambda b: _step(net, tr, *b), fault_at,
                             InjectedFault),
                     epochs=2, ckpt_every=2, **kw)
    return sup.run(), sup


_COUNTERS = ("ckpt_saves", "ckpt_restores", "ckpt_pruned",
             "resume_faults_caught", "resume_restarts")


def test_autoresume_matches_jax(tmp_path):
    """Two epochs of six steps, a checkpoint every two, a fault in
    ``step_fn`` at global step 5, in both packages from the same weights:
    the same trace within tolerance, the same final parameters, one
    restart each and the same counters."""
    jmx, jres = _jax()
    from mxnet_tpu.resilience import (AutoResume as JAutoResume,
                                      CheckpointManager as JManager)

    jnet, jtr = _jax_net_and_trainer()
    net = _carried(jnet)
    tr = _trainer(net)

    def jstep(batch):
        x, y = jmx.nd.array(batch[0]), jmx.nd.array(batch[1])
        with jmx.autograd.record():
            loss = ((jnet(x) - y) ** 2).mean()
        loss.backward()
        jtr.step(BATCH)
        return float(loss.asnumpy())

    jres.reset_resilience_counters()
    jmgr = JManager(str(tmp_path / "jax"), trainer=jtr, async_mode=True,
                    keep=3)
    jsup = JAutoResume(jmgr, _data, _faulty(jstep, 5, jres.InjectedFault),
                       epochs=2, ckpt_every=2)
    jtrace = jsup.run()
    trace, sup = _port_job(tmp_path / "port", net, tr, fault_at=5)
    assert len(trace) == len(jtrace) == 12
    assert sorted(sup.losses) == list(range(12))
    onp.testing.assert_allclose(trace, jtrace, rtol=RTOL, atol=ATOL)
    jparams = {k: v.data().asnumpy()
               for k, v in jnet._collect_params_with_prefix().items()}
    for k, v in net._collect_params_with_prefix().items():
        onp.testing.assert_allclose(v.data().asnumpy(), jparams[k],
                                    rtol=RTOL, atol=ATOL)
    assert sup.restarts == jsup.restarts == 1
    jc, pc = jres.resilience_counters(), resilience.resilience_counters()
    assert {k: pc[k] for k in _COUNTERS} == {k: jc[k] for k in _COUNTERS}
    assert pc["resume_restarts"] == 1 and pc["ckpt_restores"] == 1


@pytest.mark.parametrize("episode", ["dropout", "amp_skip"])
def test_autoresume_bitwise_in_the_port(tmp_path, episode):
    """The port alone, dropout 0.5 on: a run with a fault at global step
    5 (``dropout``), or at step 6 after an AMP overflow at step 2 and a
    halved scale (``amp_skip``, the JAX package's ``:707``), ends with the
    uninterrupted run's parameters and trace, bit for bit."""
    amp = episode == "amp_skip"
    kw = dict(poison=(0, 2)) if amp else {}
    fault = 6 if amp else 5
    runs = []
    for name, at in (("clean", None), ("fault", fault)):
        net = _net(seed=11)
        tr = _trainer(net, scaler=amp)
        trace, sup = _port_job(tmp_path / name, net, tr, fault_at=at, **kw)
        runs.append((trace, _pbytes(net), sup.restarts,
                     (tr._amp_loss_scaler.loss_scale,
                      tr._fused_skipped_steps()) if amp else None))
    (t0, p0, r0, s0), (t1, p1, r1, s1) = runs
    assert (r0, r1) == (0, 1)
    assert p1 == p0
    assert onp.array_equal(onp.asarray(t1), onp.asarray(t0), equal_nan=True)
    assert s1 == s0
    if amp:  # the episode happened: one skip, the scale halved and regrown
        assert onp.isnan(t0[2]) and s0 == (2.0 ** 10, 1)


def test_autoresume_exhausts_its_budget(tmp_path):
    net = _net()
    tr = _trainer(net)
    mgr = CheckpointManager(str(tmp_path), trainer=tr, async_mode=False)

    def always(batch):
        raise InjectedFault("every step")

    with pytest.raises(ResumeExhausted) as ei:
        AutoResume(mgr, _data, always, epochs=1, max_restarts=2).run()
    assert ei.value.restarts == 3
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert resilience.resilience_counters()["resume_restarts"] == 2


def test_autoresume_budget_from_the_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_RESUME_MAX_RESTARTS", "1")
    net = _net()
    mgr = CheckpointManager(str(tmp_path), trainer=_trainer(net),
                            async_mode=False)
    sup = AutoResume(mgr, _data, lambda b: None)
    assert sup.max_restarts == 1


def test_autoresume_propagates_when_resilience_is_off(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("MXNET_RESILIENCE", "0")
    net = _net()
    tr = _trainer(net)
    with pytest.raises(InjectedFault):
        _port_job(tmp_path, net, tr, fault_at=2)
    c = resilience.resilience_counters()
    assert c["resume_faults_caught"] == 1 and c["resume_restarts"] == 0
    assert c["ckpt_saves"] >= 1  # it still checkpointed


def test_autoresume_over_a_device_feed_fault(tmp_path):
    """The fault fires inside ``DeviceFeed``'s staging thread, reaches the
    loop, and the resumed run ends where the clean one does."""
    from mxnet_tpu_torch.pipeline import DeviceFeed

    def job(ckpt_dir, fault):
        net = _net(seed=13)
        tr = _trainer(net)

        def factory(epoch):
            rs = onp.random.RandomState(900 + epoch)
            src = ((rs.rand(BATCH, DIM).astype("f"),
                    rs.rand(BATCH, OUT).astype("f")) for _ in range(4))
            return DeviceFeed(src, depth=2, device=CPU)

        def step_fn(batch):
            x, y = batch
            with autograd.record():
                loss = ((net(x) - y) ** 2).mean()
            loss.backward()
            tr.step(BATCH)
            return float(loss.asscalar())

        mgr = CheckpointManager(str(ckpt_dir), trainer=tr, async_mode=True)
        sup = AutoResume(mgr, factory, step_fn, epochs=1, ckpt_every=2)
        if fault:
            with faults.inject("device_put", at=6):
                trace = sup.run()
        else:
            trace = sup.run()
        return trace, _pbytes(net), sup.restarts

    t0, p0, _ = job(tmp_path / "clean", False)
    t1, p1, restarts = job(tmp_path / "fault", True)
    assert restarts == 1 and p1 == p0 and t1 == t0


# -- DeviceFeed's cursor ------------------------------------------------------

def _feed_source(n=6):
    return (onp.full((2,), float(i), "f") for i in range(n))


def _cursor_walk(DeviceFeed, value, **kw):
    """position through a pass, a skip-based resume and a second resume
    in the same epoch (a crash after the first resume)."""
    out = []
    feed = DeviceFeed(_feed_source(), depth=2, **kw)
    out.append(feed.position)
    it = iter(feed)
    next(it), next(it)
    out.append(feed.position)
    feed.close()
    first = DeviceFeed(_feed_source(), depth=0, **kw).skip(2)
    out.append(first.position)
    it = iter(first)
    out.append(value(next(it)))
    out.append(first.position)  # the crash: a checkpoint reads this
    resume_at = first.position
    first.close()
    second = DeviceFeed(_feed_source(), depth=2, **kw).skip(resume_at)
    out.append(second.position)
    out.append([value(b) for b in second])
    out.append(second.position)
    try:
        DeviceFeed([onp.zeros(2, "f")] * 3, depth=0, **kw).skip(1)
    except RuntimeError as e:
        out.append(type(e).__name__)
    started = DeviceFeed(_feed_source(), depth=0, **kw)
    next(iter(started))
    try:
        started.skip(1)
    except RuntimeError as e:
        out.append(type(e).__name__)
    return out


def test_device_feed_position_and_skip_match_jax():
    from mxnet_tpu.pipeline import DeviceFeed as JFeed

    from mxnet_tpu_torch.pipeline import DeviceFeed

    want = _cursor_walk(JFeed, lambda b: float(b.asnumpy()[0]))
    got = _cursor_walk(DeviceFeed, lambda b: float(b.asnumpy()[0]),
                       device=CPU)
    assert got == want
    assert got[:6] == [0, 2, 2, 2.0, 3, 3]
    assert got[6:8] == [[3.0, 4.0, 5.0], 6]


# -- SIGKILL mid-epoch ------------------------------------------------------

CHILD_EPOCHS, CHILD_STEPS = 2, 6


def _child_data(epoch):
    rs = onp.random.RandomState(1000 + epoch)
    for _ in range(CHILD_STEPS):
        yield (rs.rand(BATCH, DIM).astype("f"),
               rs.rand(BATCH, OUT).astype("f"))


def _child_main():
    """The killed and the resumed process: a deterministic job (dropout
    draws from the generator, momentum SGD) under AutoResume with async
    checkpoints. ``RESIL_KILL_AT`` SIGKILLs the process as that global
    step starts, whatever the writer is doing; ``RESIL_OUT`` gets the
    final parameters and the trace."""
    ckpt_dir = os.environ["RESIL_CKPT_DIR"]
    out = os.environ.get("RESIL_OUT")
    kill_at = int(os.environ.get("RESIL_KILL_AT", "0"))
    net = _net(seed=42)
    tr = _trainer(net)
    count = {"g": 0, "resumed_at": None}

    def on_restore(cursor):
        count["g"] = cursor["global_step"]
        if count["resumed_at"] is None:
            count["resumed_at"] = cursor["global_step"]

    def step_fn(batch):
        if kill_at and count["g"] == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        count["g"] += 1
        return _step(net, tr, *batch)

    mgr = CheckpointManager(ckpt_dir, trainer=tr, async_mode=True, keep=3)
    sup = AutoResume(mgr, _child_data, step_fn, epochs=CHILD_EPOCHS,
                     ckpt_every=3, on_restore=on_restore)
    trace = sup.run()
    if out:
        onp.savez(out, trace=onp.asarray(trace, "float64"),
                  **{k: p.data().asnumpy() for k, p in
                     net._collect_params_with_prefix().items()})
    print(f"done restarts={sup.restarts} steps={len(trace)} "
          f"resumed_at={count['resumed_at']}")


def _run_child(env_extra):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXNET_FAULT_PLAN", None)
    env.update(env_extra)
    return subprocess.run([sys.executable, os.path.abspath(__file__)],
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_sigkill_mid_epoch_resumes_bitwise(tmp_path):
    """A process SIGKILLed at global step 8 of 12 (the writer may be
    mid-write; the last checkpoint was at 6) and a second one running the
    same job: the final parameters and the trace are bitwise an
    uninterrupted process's, and no ``.tmp-*`` is left."""
    ref = str(tmp_path / "ref.npz")
    proc = _run_child({"RESIL_CKPT_DIR": str(tmp_path / "ck_ref"),
                       "RESIL_OUT": ref})
    assert proc.returncode == 0, proc.stderr
    kill_dir = str(tmp_path / "ck_kill")
    proc = _run_child({"RESIL_CKPT_DIR": kill_dir, "RESIL_KILL_AT": "8"})
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert os.listdir(kill_dir)  # checkpoints survived the kill
    res = str(tmp_path / "resumed.npz")
    proc = _run_child({"RESIL_CKPT_DIR": kill_dir, "RESIL_OUT": res})
    assert proc.returncode == 0, proc.stderr
    # the second process resumed from the killed one's checkpoint at 6,
    # or at 3 when the kill tore the write of 6
    assert "done restarts=0 steps=12 resumed_at=" in proc.stdout
    assert int(proc.stdout.split("resumed_at=")[1].split()[0]) in (3, 6)
    a, b = onp.load(ref), onp.load(res)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert not [n for n in os.listdir(kill_dir) if n.startswith(".tmp")]


if __name__ == "__main__":
    _child_main()
