"""Test harness config.

Runs the suite on a virtual 8-device CPU mesh (like the reference's
multi-process single-host distributed tests, SURVEY §4) so sharding paths
are exercised without TPU hardware. The platform forcing lives in
``_cpu_platform.force_cpu_platform`` (shared with bench.py and
__graft_entry__.py) — it must run before any backend initializes.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _cpu_platform import force_cpu_platform  # noqa: E402

force_cpu_platform(num_devices=8)

# Lock-discipline witness ON for the whole suite (before any mxnet_tpu
# import constructs a lock): every test doubles as a lock-order test,
# and the autouse gate below fails the test that produced a violation.
os.environ.setdefault("MXNET_LOCK_CHECK", "warn")

import numpy as onp  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running benchmark/smoke runs (tier-1 excludes them "
        "via -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips "
        "without one")


# --------------------------------------------------------------------------
# Environment-gated expected failures.
#
# This container pins jax/jaxlib 0.4.37, whose CPU backend rejects
# cross-process collectives outright ("Multiprocess computations aren't
# implemented on the CPU backend") — the multi-process launch tests
# exercise exactly that path, so they cannot pass here regardless of
# framework correctness. (jax.shard_map itself is shimmed via
# mxnet_tpu.parallel._compat, which restores the single-process mesh
# tests; only the true multi-PROCESS runs stay blocked.) The xfail is
# version-gated: on a jax >= 0.5 container these run — and must pass —
# again.
_MULTIPROCESS_CPU_XFAIL = {
    "test_dist_async_hardening.py",
    "test_dist_moe_pipeline.py",
    "test_dist_multiprocess.py",
    "test_dist_ring_ulysses.py",
    "test_dist_sharded_ckpt.py",
}


def _jax_cpu_lacks_multiprocess_collectives():
    import jax

    try:
        major, minor = (int(x) for x in jax.__version__.split(".")[:2])
    except ValueError:
        return False
    return (major, minor) < (0, 5)


def pytest_collection_modifyitems(config, items):
    if not _jax_cpu_lacks_multiprocess_collectives():
        return
    import jax

    reason = (f"jaxlib {jax.__version__} CPU backend does not implement "
              "multi-process collectives (needs jax >= 0.5); the "
              "framework path is exercised single-process by "
              "test_multidevice/test_moe/test_pipeline instead")
    mark = pytest.mark.xfail(reason=reason, strict=False)
    for item in items:
        # only the tests that actually launch multiple processes — the
        # same files also hold single-process tests that must keep
        # counting as plain passes
        if item.fspath.basename in _MULTIPROCESS_CPU_XFAIL and \
                "process" in item.name:
            item.add_marker(mark)


@pytest.fixture
def forced_device_subprocess():
    """Run a python snippet in a subprocess with a FORCED virtual
    device count (1 by default — this session's 8-device forcing is
    process-wide and cannot be undone in-process). The snippet must
    print a single JSON document on its last stdout line; the helper
    returns it parsed. Used by the resharding-on-load tests to restore
    a mesh-sharded checkpoint into a genuinely single-device process."""
    import json
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(snippet, num_devices=1, env=None, timeout=600):
        code = (f"import sys; sys.path.insert(0, {root!r})\n"
                "from _cpu_platform import force_cpu_platform\n"
                f"force_cpu_platform(num_devices={num_devices})\n"
                + snippet)
        full_env = dict(os.environ, JAX_PLATFORMS="cpu")
        full_env.update(env or {})
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             env=full_env, capture_output=True,
                             text=True, timeout=timeout)
        assert out.returncode == 0, \
            f"forced-device child failed:\n{out.stderr[-4000:]}"
        return json.loads(out.stdout.strip().splitlines()[-1])

    return run


@pytest.fixture(autouse=True)
def _seed():
    import mxnet_tpu as mx

    mx.random.seed(0)
    onp.random.seed(0)
    yield


@pytest.fixture(autouse=True)
def _lock_check_gate():
    """Fail THE TEST that produced a lock-order violation (out-of-rank
    acquire, order-graph cycle, self-deadlock) under the suite-wide
    MXNET_LOCK_CHECK=warn. Witness tests that provoke violations on
    purpose wrap them in locks.capture_violations(), which removes
    them from the global record before this gate reads it."""
    from mxnet_tpu.utils import locks

    before = len(locks.violations())
    yield
    new = locks.violations()[before:]
    assert not new, (
        "lock_check violations during this test (see "
        "docs/CONCURRENCY.md):\n" +
        "\n".join(f"  [{v['kind']}] {v['message']} "
                  f"(thread={v['thread']})" for v in new))


@pytest.fixture(scope="session", autouse=True)
def _hermetic_compile_cache(tmp_path_factory):
    """Point the persistent compile cache at a per-session tmpdir so
    tier-1 runs are hermetic: no executables leak in from (or out to)
    $MXNET_HOME/compile_cache across runs, and the suite never depends
    on what a previous run happened to compile. Tests that need their
    own isolation monkeypatch MXNET_COMPILE_CACHE_DIR on top."""
    d = tmp_path_factory.mktemp("compile_cache")
    prev = os.environ.get("MXNET_COMPILE_CACHE_DIR")
    os.environ["MXNET_COMPILE_CACHE_DIR"] = str(d)
    yield str(d)
    if prev is None:
        os.environ.pop("MXNET_COMPILE_CACHE_DIR", None)
    else:
        os.environ["MXNET_COMPILE_CACHE_DIR"] = prev
