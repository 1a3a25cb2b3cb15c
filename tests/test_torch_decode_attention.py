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
                                                     _decode_flash_ref,
                                                     _decode_splits)

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


# -- K2's split key sweep (flash-decoding): the plan and the combine --------

# (B, H, S) of the paths: decode serving at GPT-2 widths (buckets 1-8 and
# the smoke's B = 32), the card tests' and the smoke's check shapes
_PATH_SHAPES = [(b, 12, 1024) for b in (1, 2, 4, 7, 8, 32)] + [
    (2, 3, 40), (3, 2, 100), (2, 4, 77), (2, 2, 50), (1, 2, 33),
    (2, 2, 17), (1, 1, 33)]


def _chunks(S, splits, chunk):
    return [(c * chunk, min((c + 1) * chunk, S)) for c in range(splits)]


@pytest.mark.parametrize("B,H,S", _PATH_SHAPES + [
    (1, 12, 1), (1, 12, 63), (1, 12, 64), (1, 12, 65), (4, 2, 63),
    (1, 1, 65), (1, 1, 100000)])
@pytest.mark.parametrize("n_sm", [132, 114, 8])
def test_decode_splits_cover_the_keys_once(B, H, S, n_sm):
    splits, chunk = _decode_splits(B, H, S, n_sm)
    seen = onp.zeros(S, int)
    for lo, hi in _chunks(S, splits, chunk):
        assert lo < hi  # no block is planned past S
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if splits > 1:
        assert chunk >= 64 and chunk % 64 == 0
        # no more blocks than 2 per SM asks for
        assert B * H * (splits - 1) < 2 * n_sm


def test_decode_splits_at_the_serving_shapes():
    """The plan the smoke reports on 132 SMs: 16 chunks of 64 at batch 1,
    3 at the serving bucket 8, none at 32."""
    assert _decode_splits(1, 12, 1024, 132) == (16, 64)
    assert _decode_splits(8, 12, 1024, 132) == (3, 384)
    assert _decode_splits(32, 12, 1024, 132) == (1, 1024)


def _split_decode(q, k, v, lengths, sm_scale, splits, chunk):
    """K2 with a split sweep, in torch: each chunk's (m, l, acc) over its
    visible keys (m = -inf, l = 0 when it has none), then the combine,
    weight exp(m_c - M) for chunks with l_c > 0."""
    B, S, H, D = k.shape
    out = torch.empty(B, H, D)
    for b in range(B):
        n = int(lengths[b])
        all_masked = n <= 0
        n = S if all_masked else min(n, S)
        parts = []
        for lo, hi in _chunks(S, splits, chunk):
            hi = min(hi, n)
            if hi <= lo:
                parts.append((torch.full((H,), -float("inf")),
                               torch.zeros(H), torch.zeros(H, D)))
                continue
            s = torch.einsum("hd,jhd->hj", q[b], k[b, lo:hi]) * sm_scale
            if all_masked:
                s = torch.zeros_like(s)
            m = s.amax(-1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(-1),
                          torch.einsum("hj,jhd->hd", p, v[b, lo:hi])))
        ms = torch.stack([m for m, _, _ in parts])
        ls = torch.stack([l for _, l, _ in parts])
        M = torch.where(ls > 0, ms, torch.full_like(ms, -float("inf")))
        M = M.amax(0)
        w = torch.where(ls > 0, torch.exp(ms - M), torch.zeros_like(ms))
        assert torch.isfinite(w).all()
        acc = sum(wc[:, None] * a for wc, (_, _, a) in zip(w, parts))
        out[b] = acc / (w * ls).sum(0).clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("B,H,S,D", [(7, 2, 300, 16), (7, 2, 1024, 32)])
def test_split_combine_matches_plain_and_jax(B, H, S, D):
    """Partials plus combine against ``_decode_flash_ref`` and the JAX op
    (``impl="lax"``, lengths = pos + 1) within 1e-6, at lengths <= 0, 1,
    chunk - 1, chunk, chunk + 1, S and > S in one batch: chunks that see
    no visible key included."""
    splits, chunk = _decode_splits(B, H, S, 132)
    assert splits > 2
    lengths = onp.array([-3, 1, chunk - 1, chunk, chunk + 1, S, S + 50],
                        "int32")
    q, kc, vc = _inputs(13, B, S, H * D)
    qt = torch.from_numpy(q).reshape(B, H, D)
    kt = torch.from_numpy(kc).reshape(B, S, H, D)
    vt = torch.from_numpy(vc).reshape(B, S, H, D)
    got = _split_decode(qt, kt, vt, lengths, D ** -0.5, splits, chunk)
    plain = _decode_flash_ref(qt, kt, vt, torch.from_numpy(lengths),
                              D ** -0.5)
    assert float((got - plain).abs().max()) < 1e-6
    want = _jax_decode(q, kc, vc, (lengths - 1)[:, None], H, "lax")
    assert onp.abs(got.reshape(B, H * D).numpy() - want).max() < 1e-6


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000, 1024])
def test_split_combine_at_batch_one(n):
    S, H, D = 1024, 12, 64
    splits, chunk = _decode_splits(1, H, S, 132)
    q, kc, vc = _inputs(n + 1, 1, S, H * D)
    args = (torch.from_numpy(q).reshape(1, H, D),
            torch.from_numpy(kc).reshape(1, S, H, D),
            torch.from_numpy(vc).reshape(1, S, H, D))
    lengths = torch.tensor([n], dtype=torch.int32)
    got = _split_decode(*args, lengths, D ** -0.5, splits, chunk)
    assert float((got - _decode_flash_ref(*args, lengths, D ** -0.5))
                 .abs().max()) < 1e-6
