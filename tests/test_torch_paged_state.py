"""The port's SessionStateStore against the JAX package's, on the CPU.

Both stores run the same open / acquire / gather / scatter / release /
evict sequence on numpy states made from a seed. The port must agree
EXACTLY (copies and bookkeeping, no arithmetic): ``read()`` rows are
bitwise equal, ``stats()`` page counts equal, and the same sessions are
evicted in the same order. Covered: page boundaries, the null page,
page exhaustion with LRU reclaim, a TTL sweep, the eviction fault seam,
and an export/restore round trip across ``page_tokens`` and into
row-slot mode.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.serving import state as jstate
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serving import state as tstate

SEQ, E = 16, 6
SHAPES = [(SEQ, E), (SEQ, E), (1,)]
DTYPES = ["float32", "float32", "int32"]
PAGEABLE = [True, True, False]
PAGE_BYTES = 4 * E * 4 * 2  # page_tokens 4, two fp32 pools
SLOT_BYTES = 4


def _pair(**kw):
    """(JAX store, port store) built with the same arguments."""
    j = jstate.SessionStateStore(SHAPES, DTYPES, pageable=PAGEABLE, **kw)
    t = tstate.SessionStateStore(SHAPES, DTYPES, pageable=PAGEABLE,
                                 ctx=mx.cpu(), **kw)
    return j, t


@pytest.fixture
def pair():
    made = []

    def build(**kw):
        kw.setdefault("ttl_s", 0)
        p = _pair(**kw)
        made.append(p)
        return p

    yield build
    for j, t in made:
        j.close()
        t.close()


def _step(store, sids, rs_state, torch_side):
    """One decode step of ``sids`` as the batcher runs it: acquire,
    gather, write this step's K/V row at the session's position (values
    from a seeded stream, the same for both stores), scatter, release.
    Returns the gathered rows as numpy (to compare what each store
    handed the step)."""
    recs = [store.acquire(s) for s in sids]
    got = store.gather(recs)
    host = [onp.array(g) if not torch_side else g.numpy().copy()
            for g in got]
    rows = rs_state.standard_normal((len(sids), 2, E)).astype("float32")
    new = [h.copy() for h in host]
    for r, rec in enumerate(recs):
        pos = int(host[2][r, 0])
        if pos < SEQ:
            new[0][r, pos] = rows[r, 0]
            new[1][r, pos] = rows[r, 1]
        new[2][r, 0] = pos + 1
    if torch_side:
        store.scatter(recs, [torch.from_numpy(n) for n in new])
    else:
        store.scatter(recs, new)
    for rec in recs:
        store.release(rec)
    return host


def _run(store, plan, torch_side, seed=0):
    """Drive ``plan`` (a list of ("open", sid) / ("step", [sids]) /
    ("evict", sid)) and record what each step gathered and any
    per-session errors."""
    rs = onp.random.RandomState(seed)
    log = []
    for op, arg in plan:
        if op == "open":
            store.open(arg)
        elif op == "evict":
            store.evict(arg)
        else:
            try:
                log.append(_step(store, arg, rs, torch_side))
            except Exception as e:  # noqa: BLE001 — compared by type
                log.append(type(e).__name__)
    return log


def _assert_same(j, t):
    assert t.stats() == j.stats()
    assert t.live_sessions() == j.live_sessions()
    assert list(t._evicted.items()) == list(j._evicted.items())
    for sid in j.live_sessions():
        for a, b in zip(j.read(sid), t.read(sid)):
            assert a.dtype == b.dtype and onp.array_equal(a, b), sid


def _assert_logs(jlog, tlog):
    assert len(jlog) == len(tlog)
    for a, b in zip(jlog, tlog):
        if isinstance(a, str):
            assert a == b
        else:
            for x, y in zip(a, b):
                assert onp.array_equal(x, y)


def test_geometry_matches_reference(pair):
    for kw in (dict(page_tokens=4, byte_budget=0, max_sessions=3),
               dict(page_tokens=8, byte_budget=3000, max_sessions=8),
               dict(page_tokens=0, byte_budget=2000, max_sessions=8)):
        j, t = pair(**kw)
        assert (t.num_slots, t.num_pages, t.paged, t._page_bytes) == \
            (j.num_slots, j.num_pages, j.paged, j._page_bytes)
        assert t.page_headroom() == j.page_headroom()
        assert repr(t).startswith(repr(j)[:-1])


def test_steps_across_page_boundaries_bitwise(pair):
    """Three streams of different lengths cross the 4-token page
    boundaries (and one runs to the full row, SEQ tokens): every
    gathered block and every dense read agrees, and the page counts
    follow ceil(steps / 4)."""
    j, t = pair(page_tokens=4, byte_budget=0, max_sessions=4)
    plan = [("open", s) for s in "abc"]
    for k in range(SEQ):
        plan.append(("step", [s for s, n in (("a", 3), ("b", 9),
                                             ("c", SEQ)) if k < n]))
    _assert_logs(_run(j, plan, False), _run(t, plan, True))
    _assert_same(j, t)
    assert t.stats()["pages_used"] == 1 + 3 + 4
    assert t._page_probe() == j._page_probe()


def test_null_page_gathers_zeros(pair):
    """A fresh session's table is all null pages: its whole dense row
    gathers as zeros, and the null page is never written."""
    j, t = pair(page_tokens=4, byte_budget=0, max_sessions=2)
    for s in (j, t):
        s.open("x")
    plan = [("step", ["x"])] * 5
    _run(j, plan, False)
    _run(t, plan, True)
    _assert_same(j, t)
    t.open("y")
    rec = t.acquire("y")
    try:
        dense = t.gather([rec], pad_to=3)
    finally:
        t.release(rec, stepped=False)
    assert all(d.shape[0] == 3 and not d.any() for d in dense)
    assert not t._pools[0][0].any() and not t._pools[1][0].any()


def test_page_exhaustion_reclaims_whole_lru_sessions(pair):
    """A pool of 6 pages: streams that outgrow it evict whole LRU
    sessions (never split one), in the reference's order, and the
    victims' next steps raise SessionEvicted in both."""
    budget = 4 * SLOT_BYTES + 6 * PAGE_BYTES
    j, t = pair(page_tokens=4, byte_budget=budget, max_sessions=4)
    assert (t.num_pages, t.num_slots) == (j.num_pages, j.num_slots) == (6, 4)
    plan = [("open", s) for s in "abcd"]
    plan += [("step", ["a", "b"])] * 5  # a, b: 2 pages each
    plan += [("step", ["c"])] * 4  # c: 1 page
    plan += [("step", ["d"])] * 9  # d needs 3 pages: evicts a, then b
    plan += [("step", ["a"]), ("step", ["c", "d"]), ("open", "e"),
             ("step", ["e"])]
    _assert_logs(_run(j, plan, False), _run(t, plan, True))
    _assert_same(j, t)
    assert list(t._evicted) == ["a", "b"]


def test_slot_pressure_and_ttl_sweep(pair, monkeypatch):
    """On one fake clock: an idle-expired session is swept first, then
    the LRU one makes room, in both stores alike."""
    import time

    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    j, t = pair(page_tokens=4, byte_budget=0, max_sessions=2, ttl_s=5.0)
    for s in (j, t):
        s.open("old")
    now[0] += 10.0
    plan = [("open", "n1"), ("step", ["n1"]), ("open", "n2"),
            ("step", ["n2"]), ("open", "n3"), ("step", ["n1", "n3"])]
    _assert_logs(_run(j, plan, False), _run(t, plan, True))
    _assert_same(j, t)
    assert list(t._evicted) == ["old", "n1"]


def test_eviction_fault_seam_hits_one_session(pair):
    j, t = pair(page_tokens=4, byte_budget=0, max_sessions=3)
    plan = [("open", "a"), ("open", "b"), ("step", ["a", "b"]),
            ("step", ["a"]), ("step", ["b"])]
    with jfaults.inject("session_state_evict", at=3):
        jlog = _run(j, plan, False)
    with tfaults.inject("session_state_evict", at=3):
        tlog = _run(t, plan, True)
    _assert_logs(jlog, tlog)
    assert tlog[1] == "SessionEvicted" and not isinstance(tlog[2], str)
    _assert_same(j, t)


@pytest.mark.parametrize("dst_tokens", [8, 2, 0])
def test_export_restore_across_page_tokens(pair, dst_tokens):
    """A paged store's export restores into another page geometry (and
    into row-slot mode) with every dense row and step count intact, as
    the reference's does; the streams then continue alike."""
    j, t = pair(page_tokens=4, byte_budget=0, max_sessions=3)
    plan = [("open", s) for s in "ab"]
    plan += [("step", ["a", "b"])] * 6 + [("step", ["b"])] * 3
    _run(j, plan, False)
    _run(t, plan, True)
    jp, tp = j.export_state(), t.export_state()
    assert sorted(tp["sessions"]) == sorted(jp["sessions"])
    for sid, ent in jp["sessions"].items():
        assert tp["sessions"][sid]["steps"] == ent["steps"]
        for a, b in zip(ent["states"], tp["sessions"][sid]["states"]):
            assert onp.array_equal(a, b)
    j2, t2 = pair(page_tokens=dst_tokens, byte_budget=0, max_sessions=3)
    assert j2.restore_state(jp) == t2.restore_state(tp) == 2
    more = [("step", ["a", "b"])] * 4
    _assert_logs(_run(j2, more, False, seed=1), _run(t2, more, True, seed=1))
    _assert_same(j2, t2)


@pytest.mark.parametrize("extra_axes", [0, 1])
def test_int8_page_codes_match_reference(extra_axes):
    """``kv_page_codes`` and ``dequantize_kv_pages`` (the int8 pages'
    arithmetic) against the JAX functions: codes, scales and the
    dequantized pages bit for bit, a page of zeros exact zeros."""
    import jax.numpy as jnp
    from mxnet_tpu.analysis import quantize as jq
    from mxnet_tpu_torch.analysis import quantize as tq

    rs = onp.random.RandomState(8)
    pages = (rs.standard_normal((12, 4, E)) *
             rs.uniform(1e-3, 50.0, (12, 1, 1))).astype("float32")
    pages[5] = 0.0
    jc, js = jq.kv_page_codes(jnp.asarray(pages))
    tc, ts = tq.kv_page_codes(torch.from_numpy(pages))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    onp.testing.assert_array_equal(tc.numpy(), onp.asarray(jc))
    onp.testing.assert_array_equal(ts.numpy(), onp.asarray(js))
    lead = (3,) * extra_axes
    jq_, jsc = jnp.broadcast_to(jc, lead + jc.shape), \
        jnp.broadcast_to(js, lead + js.shape)
    tq_, tsc = tc.expand(lead + tuple(tc.shape)), \
        ts.expand(lead + tuple(ts.shape))
    back = tq.dequantize_kv_pages(tq_, tsc).numpy()
    onp.testing.assert_array_equal(
        back, onp.asarray(jq.dequantize_kv_pages(jq_, jsc)))
    assert (back[..., 5, :, :] == 0).all()


def test_gather_into_caller_buffers(pair):
    """``gather(out=)`` writes the live rows in place and zeroes the
    rest, whatever the buffers held."""
    _, t = pair(page_tokens=4, byte_budget=0, max_sessions=2)
    t.open("x", init_states=[onp.ones(s, d) for s, d in
                             zip(SHAPES, DTYPES)])
    bufs = [torch.full((3,) + s, 7, dtype=torch.float32 if d == "float32"
                       else torch.int32) for s, d in zip(SHAPES, DTYPES)]
    rec = t.acquire("x")
    try:
        got = t.gather([rec], out=bufs)
    finally:
        t.release(rec, stepped=False)
    assert all(g is b for g, b in zip(got, bufs))
    assert all((b[0] == 1).all() and not b[1:].any() for b in bufs)
    with pytest.raises(mx.MXNetError, match="cannot hold"):
        t.gather([rec], out=[b[:, :2] for b in bufs])
