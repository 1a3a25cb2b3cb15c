"""``dist_async`` across processes: the port's parameter server
(``kvstore_ps.py``, on rank 0 over the rendezvous store) held to the
properties of ``tests/test_dist_async_hardening.py``'s multi-process
tests, on the CPU.

The JAX package's own multi-process async tests fail in this
environment (ROADMAP C), so the reference here is their properties:
every push lands exactly once (no lost or doubled updates), a worker's
pull sees its own pushes, a push does not wait for a sleeping peer, and
three workers' interleaved pushes all land.
"""
import sys

from _dist_harness import REPO

from mxnet_tpu_torch.tools import launch

PREAMBLE = r"""
import os, sys, time
import numpy as onp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

outdir = sys.argv[1]
CPU = mx.cpu()
kv = mx.kv.create("dist_async")
rank, size = kv.rank, kv.num_workers
assert kv._ps is not None


def value(key, shape):
    out = nd.zeros(shape, ctx=CPU)
    kv.pull(key, out=out)
    return float(out.asnumpy()[0])


def settle(key, shape, expect):
    deadline = time.monotonic() + 60
    v = None
    while time.monotonic() < deadline:
        v = value(key, shape)
        if abs(v - expect) < 1e-3:
            break
        time.sleep(0.05)
    return v


def report(ok, msg):
    with open(os.path.join(outdir, "r%d.txt" % rank), "w") as f:
        f.write("OK" if ok else "BAD " + msg)
"""

NO_LOST_UPDATES = r"""
assert size == 2
kv.init("w", nd.zeros((4,), ctx=CPU))
ROUNDS = 6
ok, msg = True, ""
for r in range(1, ROUNDS + 1):
    kv.push("w", nd.ones((4,), ctx=CPU) * (r * (10 ** rank)))
    v = value("w", (4,))
    own = sum(q * (10 ** rank) for q in range(1, r + 1))
    if v < own - 1e-4:  # read-your-writes
        ok, msg = False, "round %d: %r < own %r" % (r, v, own)
expect = sum(range(1, ROUNDS + 1)) * 11.0
final = settle("w", (4,), expect)
ok = ok and abs(final - expect) < 1e-3
report(ok, msg + " final=%r expect=%r" % (final, expect))
kv.barrier()
"""

ACTUALLY_ASYNC = r"""
kv.init("w", nd.zeros((2,), ctx=CPU))
if rank == 0:
    t0 = time.monotonic()
    kv.push("w", nd.ones((2,), ctx=CPU))
    v = value("w", (2,))
    elapsed = time.monotonic() - t0
    report(v >= 1.0 - 1e-6 and elapsed < 5.0, "v=%r elapsed=%r" % (v, elapsed))
else:
    time.sleep(8.0)  # a synchronous push would hold rank 0 this long
    kv.push("w", nd.ones((2,), ctx=CPU) * 2)
    v = value("w", (2,))
    report(v >= 2.0 - 1e-6, "v=%r" % v)
kv.barrier()
"""

INTERLEAVE = r"""
assert size == 3
kv.set_optimizer(mx.optimizer.SGD(learning_rate=-1.0))  # w += grad
kv.init("w", nd.zeros((2,), ctx=CPU))
for r in range(1, 5):
    kv.push("w", nd.ones((2,), ctx=CPU) * (r * (10 ** rank)))
    time.sleep(0.01 * rank)
expect = sum(range(1, 5)) * 111.0
final = settle("w", (2,), expect)
report(abs(final - expect) < 1e-3, "final=%r expect=%r" % (final, expect))
kv.barrier()
"""


GAP = r"""
kv.init("w", nd.zeros((2,), ctx=CPU))
kv.barrier()
if rank == 1:
    kv._ps._c.add(kv._ps._k("seq", "w"), 1)  # a number taken, never sent
    kv.push("w", nd.ones((2,), ctx=CPU) * 5)
v = settle("w", (2,), 5.0)
report(abs(v - 5.0) < 1e-6, "v=%r" % v)
kv.barrier()
"""


def _run(tmp_path, body, n, env=None):
    worker = tmp_path / "worker.py"
    worker.write_text(PREAMBLE + body)
    proc = launch.run_local(
        [sys.executable, str(worker), str(tmp_path)], n,
        env=dict({"MXNET_DIST_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
                  "PYTHONPATH": REPO}, **(env or {})), timeout=150, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    for rank in range(n):
        p = tmp_path / f"r{rank}.txt"
        assert p.is_file(), f"worker {rank} wrote nothing"
        assert p.read_text() == "OK", p.read_text()


def test_two_process_async_no_lost_updates(tmp_path):
    _run(tmp_path, NO_LOST_UPDATES, 2)


def test_two_process_async_is_actually_async(tmp_path):
    _run(tmp_path, ACTUALLY_ASYNC, 2)


def test_three_process_async_interleave(tmp_path):
    """The server applies each key's pushes in their numbered order,
    through the updater (an SGD step of rate -1 adds the gradient)."""
    _run(tmp_path, INTERLEAVE, 3)


def test_a_push_that_never_lands_is_given_up_after_the_tolerance(tmp_path):
    """A worker that takes a push number and dies before sending holds
    the key only for ``MXNET_KVSTORE_GAP_TOLERANCE`` seconds; the pushes
    after it still land."""
    _run(tmp_path, GAP, 2, {"MXNET_KVSTORE_GAP_TOLERANCE": "1"})
