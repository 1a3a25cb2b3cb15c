"""Per-operator times (reference: benchmark/opperf/ ``run_performance_test``
and the category sweeps), the counterpart of
``mxnet_tpu/benchmark/opperf.py``: the same 14-op suite at the same
shapes, timed on the port's device.

Measurement rules:

- each op runs ``warmup`` times first (cuDNN's autotuning, cuBLAS's
  handles, the allocator's pools);
- on a CUDA device the ``runs`` calls are timed with CUDA events around
  them (the device's time; the host enqueues ahead), on the CPU with the
  host clock;
- the forward reduces every output to one float32 sum, as the JAX
  version's does; forward plus backward runs the forward recorded, takes
  the gradients of that sum, and contracts each gradient with its input
  (``sum(g * x)``), so no backward is skipped;
- float32 convolutions and products stay float32, forward and backward
  (the port's ops and its backward scope cuDNN and cuBLAS so).

    python -m mxnet_tpu_torch.benchmark.opperf            # on gpu(0)
    python -m mxnet_tpu_torch.benchmark.opperf --ops dot,conv2d --ctx cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as onp
import torch

from .. import autograd, nd
from ..context import Context, gpu, resolve_device
from ..ndarray.ndarray import NDArray, torch_dtype

__all__ = ["run_performance_test", "run_op_suite", "DEFAULT_SUITE"]


def _time_ms(fn, device, warmup, runs):
    """Mean ms per call of ``fn`` over ``runs`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) / runs * 1e3


def _sum(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    total = None
    for o in outs:
        s = o.data.float().sum()
        total = s if total is None else total + s
    return total


def run_performance_test(op_fn, inputs, run_backward=True, dtype="float32",
                         warmup=2, runs=10, flops=None, name=None, ctx=None):
    """Time one operator on ``ctx`` (default ``gpu(0)``); returns a result
    dict. ``op_fn`` takes NDArrays; ``inputs`` are shapes (uniform [0, 1)
    floats from a seed) or ready numpy arrays; ``flops``, the operations
    per call, adds a GFLOP/s column."""
    device = resolve_device(ctx if ctx is not None else gpu(0))
    rng = onp.random.RandomState(0)
    arrs = [rng.rand(*spec).astype("float32")
            if isinstance(spec, (tuple, list)) else onp.asarray(spec)
            for spec in inputs]
    cdtype = torch_dtype(dtype)
    datas = [torch.from_numpy(a).to(device) for a in arrs]
    datas = [d.to(cdtype) if d.is_floating_point() else d for d in datas]

    def fwd():
        with torch.no_grad():
            return _sum(op_fn(*[NDArray(d) for d in datas]))

    result = {"op": name or getattr(op_fn, "__name__", "op"),
              "dtype": str(dtype), "device": str(device),
              "inputs": [list(a.shape) for a in arrs],
              "fwd_ms": _time_ms(fwd, device, warmup, runs)}
    if flops:
        result["fwd_gflops"] = flops / result["fwd_ms"] / 1e6
    diff = [i for i, d in enumerate(datas) if d.is_floating_point()]
    if run_backward and not diff:
        result["backward"] = "skipped (no floating inputs)"
    elif run_backward:
        def fwd_bwd():
            xs = list(datas)
            for i in diff:
                xs[i] = datas[i].detach().requires_grad_(True)
            with autograd.record():
                total = _sum(op_fn(*[NDArray(x) for x in xs]))
            # an input the forward does not use (batch norm's moving
            # statistics in training) has no gradient to contract
            grads = autograd._torch_grad([total], [xs[i] for i in diff],
                                         None, retain_graph=False)
            return sum((g.float() * xs[i].detach().float()).sum()
                       for g, i in zip(grads, diff) if g is not None)

        result["fwd_bwd_ms"] = _time_ms(fwd_bwd, device, warmup, runs)
    return result


def _suite():
    """The JAX version's suite: one op per family, at its shapes."""
    B = 64
    return {
        "broadcast_add": (lambda a, b: nd.broadcast_add(a, b),
                          [(B, 1024), (B, 1024)], 2 * B * 1024),
        "exp": (lambda a: nd.exp(a), [(B, 1024)], None),
        "sum": (lambda a: nd.sum(a, axis=1), [(B, 4096)], None),
        "topk": (lambda a: nd.topk(a, k=8, axis=1), [(B, 1024)], None),
        "dot": (lambda a, b: nd.dot(a, b), [(512, 512), (512, 512)],
                2 * 512 ** 3),
        "batch_dot": (lambda a, b: nd.batch_dot(a, b),
                      [(B, 64, 64), (B, 64, 64)], 2 * B * 64 ** 3),
        "conv2d": (
            lambda x, w, b: nd.Convolution(x, w, b, kernel=(3, 3),
                                           num_filter=64, pad=(1, 1)),
            [(8, 64, 28, 28), (64, 64, 3, 3), (64,)],
            2 * 8 * 64 * 64 * 9 * 28 * 28),
        "fully_connected": (
            lambda x, w, b: nd.FullyConnected(x, w, b, num_hidden=1024),
            [(B, 1024), (1024, 1024), (1024,)], 2 * B * 1024 * 1024),
        "batch_norm_train": (
            lambda x, g, b, m, v: nd.batch_norm(x, g, b, m, v,
                                                use_batch_stats=True),
            [(8, 64, 28, 28), (64,), (64,), (64,), (64,)], None),
        "softmax": (lambda a: nd.softmax(a, axis=-1), [(B, 4096)], None),
        "embedding": (
            lambda i, w: nd.Embedding(i, w, input_dim=10000,
                                      output_dim=256),
            ["_idx", (10000, 256)], None),
        "layer_norm": (lambda x, g, b: nd.LayerNorm(x, g, b, axis=-1),
                       [(B, 1024), (1024,), (1024,)], None),
        "sgd_mom_update": (
            lambda w, g, m: nd.sgd_mom_update(w, g, m, lr=0.1,
                                              momentum=0.9),
            [(1024, 1024), (1024, 1024), (1024, 1024)], None),
        "transpose": (lambda a: nd.transpose(a, (1, 0)), [(2048, 2048)],
                      None),
    }


def DEFAULT_SUITE():
    """Names in the default sweep."""
    return sorted(_suite())


def run_op_suite(ops=None, dtype="float32", warmup=2, runs=10, ctx=None):
    """Run the (filtered) default sweep on ``ctx``; returns a list of
    result dicts. topk, the optimizer update and the embedding's integer
    indices run forward only, as in the JAX version."""
    suite = _suite()
    names = list(suite) if not ops else [o for o in ops if o in suite]
    unknown = [] if not ops else [o for o in ops if o not in suite]
    if unknown:
        raise ValueError(f"unknown suite ops {unknown}; "
                         f"available: {sorted(suite)}")
    results = []
    rng = onp.random.RandomState(1)
    for n in names:
        fn, shapes, flops = suite[n]
        inputs = [rng.randint(0, 10000, (64,)).astype("f")
                  if s == "_idx" else s for s in shapes]
        no_bwd = n in ("topk", "sgd_mom_update", "embedding")
        results.append(run_performance_test(
            fn, inputs, run_backward=not no_bwd, dtype=dtype,
            warmup=warmup, runs=runs, flops=flops, name=n, ctx=ctx))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ops", default=None,
                   help="comma-separated subset of the suite")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float16", "bfloat16"])
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--output", default=None, help="write JSON here")
    args = p.parse_args(argv)
    ctx = Context(args.ctx, 0)
    ops = args.ops.split(",") if args.ops else None
    results = run_op_suite(ops, dtype=args.dtype, runs=args.runs,
                           warmup=args.warmup, ctx=ctx)
    device = resolve_device(ctx)
    payload = {"device": torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu",
               "dtype": args.dtype, "results": results}
    text = json.dumps(payload, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
