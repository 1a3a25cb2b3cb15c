"""Collective bandwidth over the process group, and the kvstore's round trip.

The PyTorch counterpart of ``mxnet_tpu/tools/bandwidth.py`` (reference:
tools/bandwidth/measure.py). For each size of float32 array it times
``dist.all_reduce`` (SUM) over the process group and a ``dist_sync``
kvstore's push and pull of one key, and reports the bus rate a ring
all-reduce reaches: ``2 (n - 1) / n`` times the array's bytes moved by
each rank, over the time (with one rank nothing moves, so the rate is
the array's bytes over the time). Run it under the launcher, one
process a rank, on the ranks' devices:

  python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local \\
      python3 -m mxnet_tpu_torch.tools.bandwidth --sizes 1e6,1e7,2.56e7

Each rank prints one JSON line a size; times are the mean of ``--iters``
calls after ``--warmup``, host-timed with the device synchronized.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

__all__ = ["measure", "main"]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev, iters, warmup):
    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def measure(size, iters=10, warmup=2):
    """``{"size", "ranks", "backend", "allreduce_ms", "allreduce_gbps",
    "kvstore_ms", "kvstore_gbps"}`` for float32 arrays of ``size``
    elements on this rank's device."""
    import torch.distributed as dist

    from .. import kvstore, nd
    from .. import _rendezvous as rdv

    if not rdv.is_initialized():
        raise SystemExit("bandwidth: run under mxnet_tpu_torch.tools.launch")
    ctx = rdv.device()
    dev = ctx.torch_device
    n = rdv.world_size()
    size = int(size)
    gen = torch.Generator(device=dev).manual_seed(rdv.rank())
    x = torch.rand(size, generator=gen, device=dev)
    coll = _timed(lambda: dist.all_reduce(x), dev, iters, warmup)
    nbytes = size * 4 * (2 * (n - 1) / n if n > 1 else 1)

    kv = kvstore.create("dist_sync")
    kv.init("x", nd.zeros((size,), ctx=ctx))
    val = nd.NDArray(x)
    out = nd.zeros((size,), ctx=ctx)

    def round_trip():
        kv.push("x", val)
        kv.pull("x", out=out)

    kvt = _timed(round_trip, dev, iters, warmup)
    return {"size": size, "ranks": n, "backend": rdv.backend(),
            "allreduce_ms": coll * 1e3, "allreduce_gbps": nbytes / coll / 1e9,
            "kvstore_ms": kvt * 1e3, "kvstore_gbps": nbytes / kvt / 1e9}


def main(argv=None):
    from .. import _rendezvous as rdv

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default="1e5,1e6,1e7")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=2)
    args = parser.parse_args(argv)
    rows = [measure(float(s), args.iters, args.warmup)
            for s in args.sizes.split(",")]
    for r in rows:
        print(json.dumps(dict(r, rank=rdv.rank())), flush=True)
    return rows


if __name__ == "__main__":
    main()
