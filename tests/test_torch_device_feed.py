"""``pipeline.DeviceFeed`` and ``io.DevicePrefetchIter`` in the port.

Mirrors the JAX package's ``tests/test_pipeline_feed.py``: batches come
out in the source's order with the source's values (against the JAX
package's feed over the same data), depth 0 runs inline, a source's
exception is re-raised at the consumer's ``next()``, ``close()``
unblocks a worker stuck on the full queue, the queue is bounded, and
the counters tell hits from stalls. On the CPU the feed stages onto the
CPU (``device=mx.cpu()``); the side-stream copy, the event and the
``record_stream`` hand-over to the consumer are held on the card by
``tests/test_torch_cuda.py``. Values are compared exactly.
"""
import threading
import time

import numpy as onp
import pytest

from mxnet_tpu import io as jio
from mxnet_tpu import nd as jnd
from mxnet_tpu import pipeline as jpl
from mxnet_tpu.gluon import data as jdata

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import pipeline as pl
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.io import DevicePrefetchIter, NDArrayIter
from mxnet_tpu_torch.pipeline import DeviceFeed
from mxnet_tpu_torch.resilience import faults

CPU = mx.cpu()


def _arrays(n=8, d=4):
    return onp.arange(n * d, dtype="f").reshape(n, d), onp.arange(n, dtype="f")


def test_feed_preserves_order_and_content_and_resets():
    X, Y = _arrays()
    it = NDArrayIter(X, Y, batch_size=4)
    feed = DeviceFeed(it, depth=2, device=CPU)
    batches = list(feed)
    assert len(batches) == 2
    onp.testing.assert_array_equal(batches[0].data[0].asnumpy(), X[:4])
    onp.testing.assert_array_equal(batches[1].data[0].asnumpy(), X[4:])
    onp.testing.assert_array_equal(batches[0].label[0].asnumpy(), Y[:4])
    assert batches[0].pad == 0 and batches[0].data[0].context == CPU
    feed.reset()
    again = [b.data[0].asnumpy() for b in feed]
    assert len(again) == 2
    onp.testing.assert_array_equal(again[0], X[:4])


@pytest.mark.parametrize("depth", [0, 2])
def test_feed_over_a_shuffled_loader_matches_jax(depth):
    rs = onp.random.RandomState(0)
    X = rs.randint(0, 256, (20, 3, 3)).astype("uint8")
    Y = onp.arange(20, dtype="f")
    got = []
    for data, pipe, ctx in ((jdata, jpl, {}), (tdata, pl, {"device": CPU})):
        onp.random.seed(4)
        loader = data.DataLoader(data.ArrayDataset(X, Y), batch_size=6,
                                 shuffle=True, last_batch="discard",
                                 num_workers=2)
        got.append([(x.asnumpy(), y.asnumpy())
                    for x, y in pipe.DeviceFeed(loader, depth=depth, **ctx)])
    assert len(got[1]) == len(got[0]) == 3
    for (jx, jy), (tx, ty) in zip(*got):
        onp.testing.assert_array_equal(tx, jx)
        onp.testing.assert_array_equal(ty, jy)


def test_feed_stages_generator_tuples_dicts_and_numpy():
    def gen():
        for i in range(3):
            yield (onp.full((2, 2), float(i), "f"),
                   {"y": onp.full((2,), float(i), "f"), "tag": "t"})

    out = list(DeviceFeed(gen(), depth=2, device=CPU))
    assert len(out) == 3
    for i, (x, d) in enumerate(out):
        assert isinstance(x, nd.NDArray) and isinstance(d["y"], nd.NDArray)
        assert d["tag"] == "t"
        onp.testing.assert_array_equal(x.asnumpy(),
                                       onp.full((2, 2), float(i), "f"))


def test_feed_copies_numpy_leaves():
    """A source that reuses its numpy buffer does not change a batch
    already handed out."""
    buf = onp.zeros((3,), "f")

    def gen():
        for i in range(3):
            buf[:] = i
            yield buf

    got = [b.asnumpy().copy() for b in DeviceFeed(gen(), depth=0,
                                                  device=CPU)]
    assert [g[0] for g in got] == [0.0, 1.0, 2.0]


def test_feed_depth_bounds_staging():
    produced = []

    def gen():
        for i in range(16):
            produced.append(i)
            yield onp.full((2,), float(i), "f")

    feed = DeviceFeed(gen(), depth=2, device=CPU)
    first = next(feed)
    time.sleep(0.3)
    # consumed 1; the queue holds <= 2; the worker holds <= 1 mid-stage
    assert len(produced) <= 1 + 2 + 1, produced
    onp.testing.assert_array_equal(first.asnumpy(), [0.0, 0.0])
    feed.close()


def test_feed_depth_zero_is_inline():
    X, Y = _arrays()
    feed = DeviceFeed(NDArrayIter(X, Y, batch_size=4), depth=0, device=CPU)
    n0 = threading.active_count()
    batches = list(feed)
    assert threading.active_count() == n0
    assert len(batches) == 2
    assert batches[0].data[0].asnumpy().tobytes() == X[:4].tobytes()


def test_feed_depth_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "5")
    assert pl.prefetch_depth() == 5
    feed = DeviceFeed([onp.zeros((1,), "f")], device=CPU)
    assert feed._depth == 5
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    assert pl.prefetch_depth() == 0 and not pl.pipeline_enabled()
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH")
    assert pl.pipeline_enabled()
    feed.close()


def test_feed_reraises_a_source_exception_at_next():
    def gen():
        yield onp.ones((2,), "f")
        yield onp.ones((2,), "f") * 2
        raise ValueError("decode exploded")

    feed = DeviceFeed(gen(), depth=2, device=CPU)
    got = []
    with pytest.raises(ValueError, match="decode exploded"):
        for b in feed:
            got.append(b)
    assert len(got) == 2
    with pytest.raises(StopIteration):
        next(feed)  # the failed pass is over, not wedged
    assert pl.pipeline_counters()["feed_errors"] >= 1
    feed.close()


def test_feed_staging_fault_reaches_the_consumer():
    feed = DeviceFeed([onp.zeros((2,), "f")] * 3, depth=2, device=CPU)
    with faults.inject("device_put", at=2):
        with pytest.raises(faults.InjectedFault):
            list(feed)
    feed.close()


def test_feed_close_unblocks_a_full_queue():
    def endless():
        i = 0
        while True:
            yield onp.full((2,), float(i), "f")
            i += 1

    with DeviceFeed(endless(), depth=1, device=CPU) as feed:
        next(feed)
        time.sleep(0.1)  # the worker blocks on the full queue
    feed.close()  # a second close is a no-op
    assert float(next(iter(feed)).asnumpy()[0]) >= 0.0
    feed.close()


def test_feed_counters_hits_and_stalls():
    pl.reset_pipeline_counters()

    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield onp.full((2,), float(i), "f")

    list(DeviceFeed(slow(), depth=2, device=CPU))
    c = pl.pipeline_counters()
    assert c["prefetch_batches"] == 3
    assert c["prefetch_stalls"] >= 1
    assert c["prefetch_stall_s"] > 0
    assert c["engine_idle_s"] == c["prefetch_stall_s"]

    def fast():
        for i in range(4):
            yield onp.full((2,), float(i), "f")

    pl.reset_pipeline_counters()
    feed = DeviceFeed(fast(), depth=4, device=CPU)
    next(feed)
    time.sleep(0.2)
    for _ in feed:
        pass
    c = pl.pipeline_counters()
    assert c["prefetch_hits"] >= 3
    assert 0.0 <= c["overlap_ratio"] <= 1.0


def test_device_prefetch_iter_matches_jax():
    X, Y = _arrays(10)
    jout = [b.data[0].asnumpy() for b in jio.DevicePrefetchIter(
        jio.NDArrayIter(jnd.array(X), jnd.array(Y), batch_size=4))]
    it = DevicePrefetchIter(NDArrayIter(X, Y, batch_size=4), device=CPU)
    tout = [b.data[0].asnumpy() for b in it]
    assert it.base is not None and len(tout) == len(jout) == 3
    for j, t in zip(jout, tout):
        onp.testing.assert_array_equal(t, j)


def test_feed_defaults_to_the_card():
    """Without ``device`` the feed stages onto the current context, the
    card: with no CUDA device that raises instead of staying on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU-only rule is moot")
    with pytest.raises(mx.MXNetError, match="CUDA"):
        DeviceFeed([onp.zeros((1,), "f")])
