"""Test helpers (reference: python/mxnet/test_utils.py, the harness of the
reference's unit tests; SURVEY §4).

The PyTorch counterpart of ``mxnet_tpu/test_utils.py``: comparisons with
relative and absolute tolerances and the per-dtype ladder, random
shapes and arrays (``rand_ndarray(stype="csr" | "row_sparse")`` for the
sparse tests), the finite-difference gradient check and the per-test
seed. ``check_consistency`` is the reference's CPU-against-GPU oracle:
it runs the function on each context of ``ctx_list`` (the CPU and the
card by default) and compares every run with the first. There is no
``jit`` to compare with; a context whose device is missing raises, as
every entry point of the port does.
"""
from __future__ import annotations

import numpy as onp

from .context import Context, cpu, current_context, gpu

__all__ = ["default_context", "set_default_context", "same",
           "assert_almost_equal", "almost_equal", "rand_shape_2d",
           "rand_shape_3d", "rand_shape_nd", "rand_ndarray", "numeric_grad",
           "check_numeric_gradient", "default_tols", "effective_dtype",
           "with_seed", "check_consistency", "discard_stderr"]


def default_context():
    return current_context()


def set_default_context(ctx):
    Context._default_ctx.value = ctx


def _as_numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def same(a, b):
    return onp.array_equal(_as_numpy(a), _as_numpy(b))


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b"),
                        equal_nan=False):
    """Reference: test_utils.py assert_almost_equal (relative and
    absolute); the message names the worst element."""
    a = _as_numpy(a).astype(onp.float64)
    b = _as_numpy(b).astype(onp.float64)
    if a.shape != b.shape:
        raise AssertionError(
            f"shape mismatch: {names[0]}{a.shape} vs {names[1]}{b.shape}")
    if onp.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    rel = onp.abs(a - b) / onp.maximum(onp.maximum(onp.abs(b), atol), 1e-300)
    idx = onp.unravel_index(onp.argmax(rel), rel.shape)
    raise AssertionError(
        f"{names[0]} and {names[1]} differ: max rel err {rel.max():.3g} "
        f"at {idx} ({a[idx]} vs {b[idx]}), rtol={rtol} atol={atol}")


def almost_equal(a, b, rtol=1e-5, atol=1e-20, equal_nan=False):
    try:
        assert_almost_equal(a, b, rtol, atol, equal_nan=equal_nan)
        return True
    except AssertionError:
        return False


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(num_dim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 ctx=None, distribution="uniform"):
    """A random array from numpy's global generator (the JAX package's
    draws, so a seed gives both packages the same values): dense, or
    ``csr`` / ``row_sparse`` with about ``density`` of the entries (or
    rows) kept (default 0.5)."""
    from . import nd
    from .ndarray import sparse

    dtype = dtype or "float32"
    if distribution == "normal":
        arr = onp.random.normal(size=shape).astype(dtype)
    else:
        arr = onp.random.uniform(size=shape).astype(dtype)
    if stype in ("row_sparse", "csr"):
        density = 0.5 if density is None else density
        mask = onp.random.uniform(size=shape) < density
        if stype == "row_sparse":
            mask = onp.broadcast_to(
                mask.reshape(shape[0], -1).any(axis=1)
                .reshape((-1,) + (1,) * (len(shape) - 1)), shape)
        arr = onp.where(mask, arr, onp.zeros_like(arr))
        return sparse.cast_storage(nd.array(arr, ctx=ctx), stype)
    return nd.array(arr, ctx=ctx, dtype=dtype)


def numeric_grad(executor_fn, x, eps=1e-4):
    """Central finite differences of a scalar function at ``x`` (numpy,
    float64)."""
    x = onp.asarray(x, dtype=onp.float64)
    g = onp.zeros_like(x)
    it = onp.nditer(x, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        orig = x[idx]
        x[idx] = orig + eps
        fp = float(executor_fn(x))
        x[idx] = orig - eps
        fm = float(executor_fn(x))
        x[idx] = orig
        g[idx] = (fp - fm) / (2 * eps)
        it.iternext()
    return g


def check_numeric_gradient(fn, inputs, rtol=1e-2, atol=1e-4, eps=1e-3,
                           ctx=None):
    """The autograd gradients of ``fn`` (NDArrays to an NDArray, summed)
    at the numpy ``inputs`` against finite differences (reference:
    test_utils.py check_numeric_gradient), on ``ctx``."""
    from . import autograd, nd

    nds = [nd.array(onp.asarray(a, dtype="float32"), ctx=ctx)
           for a in inputs]
    for a in nds:
        a.attach_grad()
    with autograd.record():
        loss = nd.sum(fn(*nds))
    loss.backward()
    analytic = [a.grad.asnumpy() for a in nds]
    for i, base in enumerate(inputs):
        def f(x, _i=i):
            args = [nd.array(onp.asarray(a, dtype="float32"), ctx=ctx)
                    if j != _i else nd.array(x.astype("float32"), ctx=ctx)
                    for j, a in enumerate(inputs)]
            return float(nd.sum(fn(*args)).asnumpy())

        num = numeric_grad(f, onp.asarray(base, dtype=onp.float64), eps)
        assert_almost_equal(analytic[i], num, rtol=rtol, atol=atol,
                            names=(f"analytic[{i}]", f"numeric[{i}]"))


# dtype -> (rtol, atol): the reference's per-dtype ladder (test_utils.py
# get_tols); bfloat16 (8 mantissa bits) gets the loosest rung
_TOLS = {
    "float64": (1e-12, 1e-14),
    "float32": (1e-5, 1e-7),
    "float16": (1e-2, 1e-4),
    "bfloat16": (4e-2, 1e-3),
    "int64": (0, 0), "int32": (0, 0), "int8": (0, 0), "uint8": (0, 0),
    "bool": (0, 0),
}


def default_tols(dtype):
    """(rtol, atol) for comparisons at ``dtype`` (reference: get_tols)."""
    name = "bfloat16" if "bfloat16" in str(dtype) else str(onp.dtype(dtype))
    return _TOLS.get(name, (1e-5, 1e-7))


def effective_dtype(x):
    """The dtype name of an array, bfloat16 by name."""
    d = getattr(x, "dtype", None)
    return "bfloat16" if "bfloat16" in str(d) else str(onp.dtype(d))


def with_seed(seed=None):
    """Seed numpy's and the port's generators for one test, and print the
    seed when it fails (reference: common.py with_seed);
    ``MXNET_TEST_SEED`` picks it when ``seed`` is None."""
    import functools
    import sys

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from . import env
            from . import random as mx_random

            this = seed if seed is not None else env.get_int(
                "MXNET_TEST_SEED", onp.random.randint(0, 2 ** 31))
            onp.random.seed(this)
            mx_random.seed(this)
            try:
                return fn(*args, **kwargs)
            except BaseException:
                print(f"*** with_seed: test failed with seed={this}; "
                      f"reproduce with MXNET_TEST_SEED={this} ***",
                      file=sys.stderr)
                raise

        return wrapper

    return deco


def check_consistency(fn, inputs, rtol=None, atol=None, dtype="float32",
                      ref_fn=None, compare_with_fp32=True, ctx_list=None):
    """Run ``fn`` on ``inputs`` (numpy arrays, cast to ``dtype``) on each
    context of ``ctx_list`` (default: the CPU and ``gpu(0)``) and hold
    every run against the first within the dtype's rung (reference:
    test_utils.py check_consistency, the CPU-against-GPU oracle). For a
    half dtype each run is also held against ``ref_fn`` (default
    ``fn``) in float32 on the first context. Returns the first run's
    outputs."""
    from . import nd

    ctx_list = [cpu(), gpu(0)] if ctx_list is None else list(ctx_list)
    if rtol is None or atol is None:
        dr, da = default_tols(dtype)
        rtol = dr if rtol is None else rtol
        atol = da if atol is None else atol

    def run(ctx, dt, f):
        outs = f(*[nd.array(_as_numpy(a).astype("float32"), ctx=ctx,
                            dtype=dt) for a in inputs])
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]

    runs = [run(ctx, dtype, fn) for ctx in ctx_list]
    for ctx, outs in zip(ctx_list[1:], runs[1:]):
        for a, b in zip(runs[0], outs):
            assert_almost_equal(b.astype("float32"), a.astype("float32"),
                                rtol=rtol, atol=atol,
                                names=(str(ctx), str(ctx_list[0])))
    if compare_with_fp32 and str(dtype) in ("float16", "bfloat16"):
        ref = run(ctx_list[0], "float32", ref_fn or fn)
        for outs in runs:
            for a, r in zip(outs, ref):
                assert_almost_equal(a.astype("float32"), r, rtol=rtol,
                                    atol=atol,
                                    names=(str(dtype), "float32_ref"))
    return runs[0][0] if len(runs[0]) == 1 else runs[0]


def discard_stderr(fn):
    """A decorator the reference's tests use; here it changes nothing."""
    return fn
