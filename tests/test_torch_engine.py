"""The port's host runtime against the JAX package's: the dependency
engine (``engine.py`` over ``csrc/engine.cc``), pooled storage,
``initialize``, op libraries, ``ops``, and the engine's consumers
(``PrefetchingIter``, the DataLoader's collect op, ``nd.save``,
``nd.waitall``).

Each engine scenario of ``tests/test_engine_storage.py`` and
``tests/test_engine_io_wiring.py`` runs through both packages' engines
(the native one and ``NaiveEngine``) and must leave the same record:
the order of its effects, the exception raised at the same
``wait_for_var``, the same ``var_version``s. Exact equality: the
scenarios are deterministic by their var dependencies.
"""
import os
import threading
import time

import numpy as onp
import pytest

from mxnet_tpu import engine as jeng
from mxnet_tpu import io as jio
from mxnet_tpu import nd as jnd
from mxnet_tpu import storage as jstorage

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import engine as teng
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import storage as tstorage
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()
PKGS = {"jax": jeng, "port": teng}


def _engines(kind):
    """A fresh engine of each package: the native one or NaiveEngine."""
    out = {}
    for name, mod in PKGS.items():
        out[name] = mod.Engine(nthreads=4, nlanes=2) if kind == "native" \
            else mod.NaiveEngine()
    return out


def _close(engines):
    for e in engines.values():
        if hasattr(e, "close"):
            e.close()


# -- scenarios: each returns a record two engines must agree on --------------

def _write_serialization(e, mod):
    v = e.new_variable()
    state = {"x": 0}

    def bump():
        cur = state["x"]
        time.sleep(0)
        state["x"] = cur + 1

    for _ in range(300):
        e.push(bump, mutable_vars=(v,))
    e.wait_for_var(v)
    return state["x"], e.var_version(v)


def _concurrent_pushers(e, mod):
    v = e.new_variable()
    lock = threading.Lock()
    count = [0]

    def bump():
        with lock:
            count[0] += 1

    def producer():
        for _ in range(50):
            e.push(bump, mutable_vars=(v,))

    threads = [threading.Thread(target=producer) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    e.wait_all()
    return count[0], e.var_version(v)


def _lanes_share_dependencies(e, mod):
    v = e.new_variable()
    order = []
    e.push(lambda: (time.sleep(0.05), order.append("first"))[-1],
           mutable_vars=(v,), lane=mod.LANE_IO)
    e.push(lambda: order.append("second"), mutable_vars=(v,),
           lane=mod.LANE_COMPUTE)
    e.wait_for_var(v)
    return order, e.var_version(v)


def _readers_then_writer(e, mod):
    data, out = e.new_variable(), e.new_variable()
    log = []
    lock = threading.Lock()
    for i in range(4):
        e.push(lambda i=i: (lock.acquire(), log.append(("r", i)),
                            lock.release()), const_vars=(data,),
               mutable_vars=(out,) if i == 3 else ())
    e.push(lambda: log.append(("w", 0)), mutable_vars=(data,))
    e.wait_for_var(data)
    e.wait_for_var(out)
    # the readers may run in any order among themselves; the writer last
    return sorted(log[:4]), log[4], e.var_version(data), e.var_version(out)


def _poison(e, mod):
    a, b, c = e.new_variable(), e.new_variable(), e.new_variable()
    ran = []

    def boom():
        raise ValueError("bad record 7")

    e.push(lambda: ran.append("before"), mutable_vars=(a,))
    e.push(boom, mutable_vars=(a,), lane=mod.LANE_IO)
    e.push(lambda: ran.append("reader"), const_vars=(a,),
           mutable_vars=(b,))
    e.push(lambda: ran.append("clean"), mutable_vars=(c,))
    raised = {}
    for name, v in (("a", a), ("b", b), ("c", c)):
        try:
            e.wait_for_var(v)
            raised[name] = None
        except ValueError as err:
            raised[name] = str(err)
    return (sorted(ran), raised, e.var_version(a), e.var_version(b),
            e.var_version(c))


SCENARIOS = {"write_serialization": _write_serialization,
             "concurrent_pushers": _concurrent_pushers,
             "lanes_share_dependencies": _lanes_share_dependencies,
             "readers_then_writer": _readers_then_writer,
             "poison": _poison}


@pytest.mark.parametrize("kind", ["native", "naive"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_scenario_equals_jax(scenario, kind):
    engines = _engines(kind)
    try:
        got = {name: SCENARIOS[scenario](e, PKGS[name])
               for name, e in engines.items()}
    finally:
        _close(engines)
    assert got["port"] == got["jax"]


def test_poison_record_is_the_reference_semantics():
    e = teng.Engine(nthreads=2)
    try:
        ran, raised, va, vb, vc = _poison(e, teng)
    finally:
        e.close()
    # the reader of a poisoned var is skipped and poisoned in turn; an
    # unrelated var is clean; failed and skipped ops still bump versions
    assert ran == ["before", "clean"]
    assert raised == {"a": "bad record 7", "b": "bad record 7", "c": None}
    assert (va, vb, vc) == (2, 1, 1)


def test_io_lane_does_not_starve_compute():
    e = teng.Engine(nthreads=2, nlanes=2)
    try:
        io_var, cpu_var = e.new_variable(), e.new_variable()
        done = []
        for _ in range(2):
            e.push(lambda: (time.sleep(0.3), done.append("io")),
                   mutable_vars=(io_var,), lane=teng.LANE_IO)
        t0 = time.perf_counter()
        for _ in range(20):
            e.push(lambda: done.append("c"), mutable_vars=(cpu_var,),
                   lane=teng.LANE_COMPUTE)
        e.wait_for_var(cpu_var)
        elapsed = time.perf_counter() - t0
        assert elapsed < 0.25, f"compute waited {elapsed:.2f} s behind IO"
        assert done.count("c") == 20
        e.wait_all()
    finally:
        e.close()


def test_close_with_ops_in_flight_equals_jax():
    """close() drains the ops in flight, freezes poison for later waits,
    and runs later pushes inline, in both packages."""
    out = {}
    for name, mod in PKGS.items():
        e = mod.Engine(nthreads=2)
        v, bad = e.new_variable(), e.new_variable()
        ran = []
        for i in range(5):
            e.push(lambda i=i: (time.sleep(0.01), ran.append(i)),
                   mutable_vars=(v,), lane=mod.LANE_IO)
        e.push(lambda: (_ for _ in ()).throw(KeyError("late")),
               mutable_vars=(bad,))
        e.close()
        drained = list(ran)
        e.push(lambda: ran.append("inline"), mutable_vars=(v,))
        e.wait_for_var(v)
        with pytest.raises(KeyError, match="late"):
            e.wait_for_var(bad)
        e.close()  # idempotent
        out[name] = (drained, ran[-1], e.num_live_callbacks())
    assert out["port"] == out["jax"] == ([0, 1, 2, 3, 4], "inline", 0)


def test_keepalives_bounded_by_waits():
    e = teng.Engine(nthreads=2)
    try:
        start = e.num_live_callbacks()
        for _ in range(50):
            v = e.new_variable()
            e.push(lambda: None, mutable_vars=(v,))
            e.wait_for_var(v)
        assert e.num_live_callbacks() <= start + 1
    finally:
        e.close()


_FORK_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch import engine as teng

eng = teng.get()
v = eng.new_variable()
eng.push(lambda: None, mutable_vars=(v,), lane=teng.LANE_IO)
eng.wait_for_var(v)
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    code = 1
    try:
        os.close(r)
        child = teng.get()
        cv = child.new_variable()
        box = []
        child.push(lambda: box.append(41 + 1), mutable_vars=(cv,),
                   lane=teng.LANE_IO)
        child.wait_for_var(cv)
        os.write(w, ("%s %d" % (child is not eng, box[0])).encode())
        code = 0
    finally:
        os._exit(code)
os.close(w)
_, status = os.waitpid(pid, 0)
msg = os.read(r, 100).decode()
eng.push(lambda: None, mutable_vars=(v,))
eng.wait_for_var(v)
print(os.WEXITSTATUS(status), msg)
"""


def test_fork_after_push_gets_a_fresh_engine():
    """A child forked after an engine push (the parent's workers do not
    survive fork) builds its own engine and pushes again; the parent's
    engine goes on. In a process of its own: no JAX threads at the
    fork."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _FORK_SCRIPT, repo],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["0", "True", "42"]


_FORK_ORPHAN_SCRIPT = r"""
import gc, os, sys
sys.path.insert(0, sys.argv[1])
import mxnet_tpu_torch  # noqa: F401 -- installs the after-fork handler
from mxnet_tpu_torch import engine as teng

calls = []


class Spy:
    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in ("eng_wait_all", "eng_destroy"):
            return fn

        def spy(*args):
            calls.append((name, os.getpid()))
            return fn(*args)
        return spy


e = teng.get()
e._lib = Spy(e._lib)
v = e.new_variable()
e.push(lambda: None, mutable_vars=(v,), lane=teng.LANE_IO)
e.wait_for_var(v)
del e, v
pid = os.fork()
if pid == 0:
    code = 1
    try:
        gc.collect()  # the parent's engine may sit in a reference cycle
        if [c for c in calls if c[1] == os.getpid()]:
            code = 3
        else:
            child = teng.get()
            cv = child.new_variable()
            box = []
            child.push(lambda: box.append(1), mutable_vars=(cv,))
            child.wait_for_var(cv)
            code = 0 if box == [1] else 2
    finally:
        os._exit(code)
_, status = os.waitpid(pid, 0)
print(os.waitstatus_to_exitcode(status))
sys.stdout.flush()
os._exit(0)
"""


def test_fork_leaves_the_parents_engine_alone_in_the_child():
    """The after-fork handler drops the singleton, and with it the last
    reference to the parent's engine: its finalizer must not drain or
    join the parent's worker threads from the child (the JAX package's
    ``test_aux.py::test_fork_reinitializes_engine`` died of SIGSEGV there
    when an earlier test in its process had built the port's engine)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _FORK_ORPHAN_SCRIPT, repo],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["0"], (proc.stdout, proc.stderr[-2000:])


def test_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    """Without g++ the engine library cannot build: ``Engine()`` and
    ``engine.get()`` raise (the JAX ``get()`` would pick NaiveEngine);
    only ``MXNET_ENGINE_TYPE=NaiveEngine`` selects the naive engine."""
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path))
    with pytest.raises(MXNetError, match="g\\+\\+ not found"):
        teng.Engine()
    monkeypatch.setattr(teng, "_engine", None)
    with pytest.raises(MXNetError, match="g\\+\\+ not found"):
        teng.get()
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert isinstance(teng.get(), teng.NaiveEngine)


def test_compile_error_raises_with_the_compiler_output(monkeypatch,
                                                       tmp_path):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "engine.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_native, "_CSRC", str(bad))
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "out"))
    with pytest.raises(MXNetError, match="g\\+\\+ failed to build"):
        _native.engine_lib()


def test_library_is_the_ports_own_build():
    path = _native.build("engine")
    assert "mxnet_tpu_torch" in path or os.environ.get(
        "MXNET_COMPILE_CACHE_DIR")
    assert "mxnet_tpu/_native" not in path and "/native/" not in path
    assert _native.decoder() in ("libjpeg", "nvjpeg")


def test_engine_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "3")
    monkeypatch.setenv("MXNET_ENGINE_NUM_LANES", "3")
    e = teng.Engine()
    try:
        assert e._nlanes == 3
        v = e.new_variable()
        e.push(lambda: None, mutable_vars=(v,), lane=2)
        e.wait_for_var(v)
        assert e.var_version(v) == 1
    finally:
        e.close()


def test_device_push_on_cpu_is_a_host_op():
    """``device=`` names a card; a CPU device adds nothing to the op."""
    e = teng.Engine(nthreads=2)
    try:
        v = e.new_variable()
        box = []
        e.push(lambda: box.append(1), mutable_vars=(v,), device="cpu")
        e.wait_for_var(v)
        assert box == [1] and not e._device_events
    finally:
        e.close()


def test_engine_push_fault_seam():
    from mxnet_tpu_torch.resilience import faults

    e = teng.NaiveEngine()
    with faults.inject("engine_push", at=1):
        with pytest.raises(faults.InjectedFault):
            e.push(lambda: None)
    e.push(lambda: None)


# -- storage ------------------------------------------------------------------

def _storage_trace(mod, monkeypatch, pool_type, reserve=None):
    monkeypatch.setenv("MXNET_GPU_MEM_POOL_TYPE", pool_type)
    if reserve is not None:
        monkeypatch.setenv("MXNET_GPU_MEM_POOL_RESERVE", reserve)
    s = mod.Storage()
    stats = []
    hs = [s.alloc(n) for n in (100, 5000, 70000, 100)]
    stats.append(s.stats())
    for h in hs:
        s.free(h)
    stats.append(s.stats())
    h = s.alloc(90000)
    stats.append(s.stats())
    reused = h.ptr in {x.ptr for x in hs}
    s.direct_free(h)
    s.release_all()
    stats.append(s.stats())
    return stats, reused


@pytest.mark.parametrize("pool_type", ["Naive", "Round", "Unpooled"])
def test_storage_strategies_equal_jax(monkeypatch, pool_type):
    assert _storage_trace(tstorage, monkeypatch, pool_type) == \
        _storage_trace(jstorage, monkeypatch, pool_type)


def test_storage_reserve_cap_equals_jax(monkeypatch):
    assert _storage_trace(tstorage, monkeypatch, "Naive", "100") == \
        _storage_trace(jstorage, monkeypatch, "Naive", "100")


def test_storage_pool_disable_and_as_array(monkeypatch):
    s = tstorage.Storage()
    h = s.alloc(64)
    view = s.as_array(h, (4, 4), onp.float32)
    view[:] = 7
    assert (s.as_array(h, (16,), onp.float32) == 7).all()
    with pytest.raises(ValueError):
        s.as_array(h, (100,), onp.float32)
    s.free(h)
    monkeypatch.setenv("MXNET_CPU_MEM_POOL_DISABLE", "1")
    h = s.alloc(32)
    assert h.ptr in s._fallback
    s.free(h)
    assert not s._fallback


def test_device_memory_info_cpu_equals_jax():
    import jax

    jfree, jtotal, _ = jstorage.device_memory_info(jax.devices("cpu")[0])
    assert tstorage.device_memory_info(CPU)[:2] == (jfree, jtotal)
    assert tstorage.device_memory_info(CPU)[2] == {}


# -- initialize, features, library, ops ----------------------------------------

def test_signal_handler_feature_reports_what_was_installed(monkeypatch):
    from mxnet_tpu_torch import initialize, runtime

    assert runtime.Features().is_enabled("SIGNAL_HANDLER") == \
        initialize.installed()["signals"]
    monkeypatch.setattr(initialize, "_installed",
                        {"signals": False, "fork": True})
    monkeypatch.setenv("MXNET_USE_SIGNAL_HANDLER", "0")
    initialize.install_signal_handlers()
    assert not initialize.installed()["signals"]
    assert not runtime.Features().is_enabled("SIGNAL_HANDLER")


def test_native_io_feature_follows_the_library():
    from mxnet_tpu_torch import runtime

    _native.io_lib()
    assert runtime.Features().is_enabled("NATIVE_IO")


def test_library_load_registers_in_nd_and_sym(tmp_path):
    from mxnet_tpu_torch import library, sym

    lib = tmp_path / "oplib_cube.py"
    lib.write_text(
        "def register_ops(registry):\n"
        "    @registry.register(name='oplib_cube')\n"
        "    def oplib_cube(data):\n"
        "        return data * data * data\n")
    mod = library.load(str(lib), verbose=False)
    assert library.load(str(lib)) is mod
    assert str(lib) in library.loaded_libraries()
    x = nd.array(onp.array([1.0, 2.0, -3.0], "f"), ctx=CPU)
    onp.testing.assert_array_equal(nd.oplib_cube(x).asnumpy(),
                                   [1.0, 8.0, -27.0])
    out = sym.oplib_cube(sym.var("d")).eval_with(
        {"d": nd.array(onp.array([2.0], "f"), ctx=CPU)})
    onp.testing.assert_array_equal(out.asnumpy(), [8.0])
    with pytest.raises(MXNetError, match="not found"):
        library.load(str(tmp_path / "missing.py"))
    bad = tmp_path / "nohook.py"
    bad.write_text("x = 1\n")
    with pytest.raises(MXNetError, match="register_ops"):
        library.load(str(bad))


def test_ops_flash_attention_is_k1():
    import torch

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.kernels import flash_attention as fa

    assert ops.flash_attention is fa.flash_attention
    rs = onp.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 8, 16).astype("f"))
               for _ in range(3))
    from mxnet_tpu_torch.ops.flash_attention import _ref_attention

    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               _ref_attention(q, k, v, 0.25, False),
                               rtol=0, atol=0)


# -- the consumers ------------------------------------------------------------

@pytest.fixture(params=["native", "naive"])
def both_engines(request, monkeypatch):
    """Both packages' singletons swapped for fresh engines of one kind."""
    engines = _engines(request.param)
    monkeypatch.setattr(jeng, "_engine", engines["jax"])
    monkeypatch.setattr(teng, "_engine", engines["port"])
    yield request.param
    _close(engines)


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([b.data[0].asnumpy() for b in it])
        it.reset()
    return out


def test_prefetching_iter_equals_jax(both_engines):
    base = onp.arange(60, dtype="f").reshape(15, 4)
    j = _epochs(jio.PrefetchingIter(jio.NDArrayIter(base, batch_size=4)))
    t = _epochs(tio.PrefetchingIter(tio.NDArrayIter(base, batch_size=4)))
    assert len(j) == len(t)
    for je, te in zip(j, t):
        assert len(je) == len(te)
        for a, b in zip(je, te):
            onp.testing.assert_array_equal(a, b)


def test_prefetching_iter_fetches_on_the_engine(both_engines):
    seen = []
    base = tio.NDArrayIter(onp.zeros((8, 2), "f"), batch_size=2)
    orig = base.next

    def spy():
        seen.append(threading.get_ident())
        return orig()

    base.next = spy
    assert len(_epochs(tio.PrefetchingIter(base), 1)[0]) == 4
    if both_engines == "native":
        assert seen and threading.get_ident() not in seen
    else:  # NaiveEngine: every fetch inline, on the caller
        assert set(seen) == {threading.get_ident()}


def test_prefetching_iter_raises_at_the_waiting_next(both_engines):
    class Boom(tio.NDArrayIter):
        calls = 0

        def next(self):
            Boom.calls += 1
            if Boom.calls == 2:
                raise OSError("disk gone")
            return super().next()

    it = tio.PrefetchingIter(Boom(onp.zeros((8, 2), "f"), batch_size=2))
    it.next()
    with pytest.raises(OSError, match="disk gone"):
        it.next()
    it.reset()  # fresh vars: the next pass is clean
    assert len([b for b in it]) == 4


def test_dataloader_collects_on_the_engine_as_jax(both_engines):
    from mxnet_tpu.gluon.data import ArrayDataset as JArray
    from mxnet_tpu.gluon.data import DataLoader as JLoader
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader

    X = onp.arange(40, dtype="f").reshape(20, 2)
    Y = onp.arange(20, dtype="f")
    j = [[b[0].asnumpy(), b[1].asnumpy()]
         for b in JLoader(JArray(X, Y), batch_size=6, num_workers=2)]
    dl = DataLoader(ArrayDataset(X, Y), batch_size=6, num_workers=2)
    for _ in range(2):  # a second pass reuses the pooled vars
        t = [[b[0].asnumpy(), b[1].asnumpy()] for b in dl]
        assert len(t) == len(j) == 4
        for (ja, jb), (ta, tb) in zip(j, t):
            onp.testing.assert_array_equal(ja, ta)
            onp.testing.assert_array_equal(jb, tb)


def test_dataloader_worker_error_raises_at_its_batch(both_engines):
    from mxnet_tpu_torch.gluon.data import DataLoader, Dataset

    class Bad(Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return onp.float32(i)

    batches = iter(DataLoader(Bad(), batch_size=2, num_workers=2))
    next(batches)
    next(batches)
    with pytest.raises(KeyError, match="sample 5"):
        next(batches)


def test_nd_save_is_an_engine_op_and_equals_jax(both_engines, tmp_path):
    data = {"w": onp.arange(6, dtype="f").reshape(2, 3),
            "b": onp.array([1, -2], "int32")}
    jp, tp = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnd.save(jp, {k: jnd.array(v, dtype=v.dtype) for k, v in data.items()})
    pushed = []
    eng = teng.get()
    orig = eng.push
    eng.push = lambda fn, *a, **k: (pushed.append(k.get("lane")),
                                    orig(fn, *a, **k))[1]
    try:
        nd.save(tp, {k: nd.array(v, ctx=CPU, dtype=v.dtype)
                     for k, v in data.items()})
    finally:
        del eng.push
    assert pushed == [teng.LANE_IO]
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(OSError):
        nd.save(str(tmp_path / "no" / "dir" / "x.params"),
                {"w": nd.array(data["w"], ctx=CPU)})


def test_waitall_waits_for_the_engine_first(monkeypatch):
    calls = []
    monkeypatch.setattr(teng, "wait_all", lambda: calls.append("engine"))
    nd.waitall()
    assert calls == ["engine"]
