"""Decode attention and the KV-cache append: the PyTorch port against
the JAX package, on the CPU.

The port's ``_attention_decode(impl="torch")`` and its plain kernel
version ``_decode_flash_ref`` are held against the JAX op with
``impl="lax"`` and with ``impl="interpret"`` (the Pallas kernel
interpreted, as ``test_paged_decode.py`` runs it). Tolerance 1e-5: the
same bound the JAX package puts on lax vs interpret, since both sides
sum the softmax in fp32 but in different orders. ``_cache_append`` is an
exact index write on both sides, so it is compared bitwise.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.kernels.attention  # noqa: F401 — registers the decode ops
from mxnet_tpu.ndarray import registry as jregistry

from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.attention import _attention_decode, _cache_append
from mxnet_tpu_torch.kernels.flash_attention import (KERNEL, _decode_flash,
                                                     _decode_flash_ref)

TOL = 1e-5


def _jax_decode(q, kc, vc, pos, heads, impl):
    op = jregistry.get_op("_attention_decode")
    E = q.shape[1]
    kw = {"num_heads": heads, "sm_scale": 1.0 / (E // heads) ** 0.5,
          "impl": impl}
    args = tuple(jmx.nd.array(a) for a in (q, kc, vc, pos))
    return jregistry.invoke(op, args, kw).asnumpy()


def _port_decode(q, kc, vc, pos, heads):
    E = q.shape[1]
    return _attention_decode(
        *(torch.from_numpy(a) for a in (q, kc, vc, pos)), num_heads=heads,
        sm_scale=1.0 / (E // heads) ** 0.5, impl="torch").numpy()


def _inputs(seed, B, S, E):
    rs = onp.random.RandomState(seed)
    return (rs.randn(B, E).astype("f"), rs.randn(B, S, E).astype("f"),
            rs.randn(B, S, E).astype("f"))


# (S, E, H, pos): the JAX package's own case (D = 8), D = 24, a cache of
# one position and a long odd-length cache
CASES = [
    (16, 16, 2, [[0], [5], [15]]),
    (16, 48, 2, [[0], [5], [15]]),
    (1, 16, 2, [[0], [0], [0]]),
    (100, 16, 2, [[0], [50], [99]]),
]


@pytest.mark.parametrize("S,E,H,pos", CASES)
@pytest.mark.parametrize("jax_impl", ["lax", "interpret"])
def test_attention_decode_matches_jax(S, E, H, pos, jax_impl):
    q, kc, vc = _inputs(7, 3, S, E)
    pos = onp.array(pos, "int32")
    want = _jax_decode(q, kc, vc, pos, H, jax_impl)
    got = _port_decode(q, kc, vc, pos, H)
    assert got.shape == want.shape == (3, E)
    assert onp.abs(got - want).max() < TOL


@pytest.mark.parametrize("S,E,H,pos", CASES)
def test_decode_flash_ref_matches_jax_kernel(S, E, H, pos):
    """The plain version in the kernel's own layout — q (B, H, D), caches
    (B, S, H, D), lengths = pos + 1 — against the interpreted TPU kernel."""
    q, kc, vc = _inputs(3, 3, S, E)
    pos = onp.array(pos, "int32")
    D = E // H
    want = _jax_decode(q, kc, vc, pos, H, "interpret")
    got = _decode_flash_ref(
        torch.from_numpy(q).reshape(3, H, D),
        torch.from_numpy(kc).reshape(3, S, H, D),
        torch.from_numpy(vc).reshape(3, S, H, D),
        torch.from_numpy(pos.reshape(3) + 1), D ** -0.5).numpy()
    assert onp.abs(got.reshape(3, E) - want).max() < TOL


def test_kernel_wrapper_takes_plain_path_on_cpu_tensors():
    """On CPU tensors ``_decode_flash`` is exactly the plain version, and
    counts no kernel launch."""
    q, kc, vc = _inputs(5, 2, 16, 16)
    args = (torch.from_numpy(q).reshape(2, 2, 8),
            torch.from_numpy(kc).reshape(2, 16, 2, 8),
            torch.from_numpy(vc).reshape(2, 16, 2, 8),
            torch.tensor([3, 16], dtype=torch.int32), 8 ** -0.5)
    _build.reset_launch_counts()
    got = _decode_flash(*args)
    assert torch.equal(got, _decode_flash_ref(*args))
    assert _build.launch_counts().get(KERNEL, 0) == 0


def test_garbage_beyond_prefix_does_not_leak():
    """Cache entries past ``pos`` get exactly zero weight: overwriting
    them with garbage leaves that row bitwise unchanged (both sides)."""
    S, E, H = 16, 16, 2
    q, kc, vc = _inputs(7, 3, S, E)
    pos = onp.array([[0], [5], [S - 1]], "int32")
    garbage = onp.arange(S)[None, :, None] > 5
    kc2 = onp.where(garbage, 999.0, kc).astype("f")
    vc2 = onp.where(garbage, -999.0, vc).astype("f")
    base = _port_decode(q, kc, vc, pos, H)
    dirty = _port_decode(q, kc2, vc2, pos, H)
    assert onp.array_equal(base[:2], dirty[:2])
    assert onp.array_equal(_jax_decode(q, kc, vc, pos, H, "lax")[1],
                           _jax_decode(q, kc2, vc, pos, H, "lax")[1])


@pytest.mark.parametrize("pos", [
    [[0], [3], [7]],
    [[7], [7], [7]],      # pos = max_len - 1: the last slot
    [[8], [2], [100]],    # past the end: the write is dropped
    [[-1], [-8], [-9]],   # negative: counts from the end, or dropped
])
def test_cache_append_matches_jax_bitwise(pos):
    B, S, E = 3, 8, 4
    rs = onp.random.RandomState(11)
    cache = rs.randn(B, S, E).astype("f")
    step = rs.randn(B, E).astype("f")
    pos = onp.array(pos, "int32")
    op = jregistry.get_op("_cache_append")
    want = jregistry.invoke(op, tuple(jmx.nd.array(a) for a in
                                      (cache, step, pos)), {}).asnumpy()
    t = torch.from_numpy(cache.copy())
    got = _cache_append(t, torch.from_numpy(step), torch.from_numpy(pos))
    assert got is t  # in place, on a tensor the caller owns
    assert onp.array_equal(got.numpy(), want)


def test_cache_append_pins_the_jax_edge_rule():
    """What the JAX op does at and past ``max_len``, pinned on its own:
    ``pos = S - 1`` writes the last slot, ``pos = S`` changes nothing."""
    B, S, E = 1, 4, 2
    cache = onp.zeros((B, S, E), "f")
    step = onp.ones((B, E), "f")
    op = jregistry.get_op("_cache_append")

    def run(p):
        return jregistry.invoke(op, (jmx.nd.array(cache), jmx.nd.array(step),
                                     jmx.nd.array(onp.array([[p]], "int32"))),
                                {}).asnumpy()

    assert onp.array_equal(run(S - 1)[0, S - 1], step[0])
    assert onp.array_equal(run(S), cache)
    t = torch.zeros(B, S, E)
    _cache_append(t, torch.ones(B, E), torch.tensor([[S]], dtype=torch.int32))
    assert not t.any()
