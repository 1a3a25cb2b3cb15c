"""The port's DGL graph ops against the JAX package's on the CPU: every
case of ``tests/test_dgl_ops.py`` and the id-exactness case of
``tests/test_advice_fixes.py``, each output held bitwise (the same host
numpy work and the same ``RandomState`` draws), with the JAX package's
dtypes: float64 vertex arrays and edge ids on the host, id-exact CSRs
with int64 ids and float64 values, 0/1 CSRs with int32 ids and float32
values on the graph's device.
"""
import numpy as onp
import pytest

from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu.ndarray import contrib as jcontrib

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import contrib as tcontrib
from mxnet_tpu_torch.ndarray import sparse as sp

CPU = mx.cpu()


def _toy_parts():
    """A 5-vertex ring with chords; values are edge ids 1..nnz."""
    dense = onp.array([[0, 1, 0, 0, 1], [1, 0, 1, 0, 0], [0, 1, 0, 1, 0],
                       [0, 0, 1, 0, 1], [1, 0, 0, 1, 0]], onp.float32)
    indptr, indices, data, eid = [0], [], [], 1
    for r in range(5):
        for c in range(5):
            if dense[r, c]:
                indices.append(c)
                data.append(eid)
                eid += 1
        indptr.append(len(indices))
    return (onp.asarray(data, "f"), onp.asarray(indices, onp.int64),
            onp.asarray(indptr, onp.int64))


def _graphs():
    d, i, p = _toy_parts()
    return (jsp.CSRNDArray(d, i, p, (5, 5)),
            sp.csr_matrix((d, i, p), shape=(5, 5), ctx=CPU))


def _ids(*vals):
    return jnd.array(list(vals)), nd.array(list(vals), ctx=CPU)


def _same(t, j):
    """The port's output equals the JAX one's, values and dtypes."""
    if hasattr(j, "stype") and j.stype == "csr":
        assert t.stype == "csr" and t.shape == j.shape
        for a, b in ((t.data, j.data), (t.indices, j.indices),
                     (t.indptr, j.indptr)):
            a, b = a.asnumpy(), b.asnumpy()
            onp.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
        return
    a, b = t.asnumpy(), j.asnumpy()
    onp.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


def test_edge_id_matches_jax():
    jg, tg = _graphs()
    ju, tu = _ids(0, 0, 2, 4)
    jv, tv = _ids(1, 2, 3, 0)
    j, t = jcontrib.edge_id(jg, ju, jv), tcontrib.edge_id(tg, tu, tv)
    _same(t, j)
    out = t.asnumpy()
    assert out[0] == 1 and out[1] == -1 and out[2] > 0
    assert t.context == CPU


def test_dgl_adjacency_matches_jax():
    jg, tg = _graphs()
    t = nd.contrib.dgl_adjacency(tg)
    _same(t, jcontrib.dgl_adjacency(jg))
    assert t.stype == "csr" and t.context == CPU
    onp.testing.assert_array_equal(t.data.asnumpy(), onp.ones(tg.nnz, "f"))


@pytest.mark.parametrize("vids", [(0, 1, 4), (0, 1), (4, 2, 0, 3, 1),
                                  (3, 3, 1), (2, -1, 4)])
def test_dgl_subgraph_and_mapping_match_jax(vids):
    jg, tg = _graphs()
    jv, tv = _ids(*vids)
    jsub, jmap = jcontrib.dgl_subgraph(jg, jv, return_mapping=True)
    tsub, tmap = tcontrib.dgl_subgraph(tg, tv, return_mapping=True)
    _same(tsub, jsub)
    _same(tmap, jmap)
    (tonly,) = tcontrib.dgl_subgraph(tg, tv)
    _same(tonly, jsub)
    if vids == (0, 1, 4):
        expect = onp.array([[0, 1, 1], [1, 0, 0], [1, 0, 0]], "f")
        onp.testing.assert_array_equal(
            (tsub.asnumpy() > 0).astype("f"), expect)
    if vids == (0, 1):
        md = tmap.asnumpy()
        assert md[0, 1] == 1.0 and md[1, 0] >= 1.0


@pytest.mark.parametrize("seeds,hops,nbr,cap,seed", [
    ((0,), 1, 2, 10, 0), ((0, 1, 2, 3, 4), 3, 5, 4, 0), ((2,), 2, 1, 10, 3),
    ((1, 3), 2, 2, 10, 7)])
def test_uniform_sample_matches_jax(seeds, hops, nbr, cap, seed):
    jg, tg = _graphs()
    js, ts = _ids(*seeds)
    kw = dict(num_hops=hops, num_neighbor=nbr, max_num_vertices=cap,
              seed=seed)
    jv, jsub = jcontrib.dgl_csr_neighbor_uniform_sample(jg, js, **kw)
    tv, tsub = nd.contrib.dgl_csr_neighbor_uniform_sample(tg, ts, **kw)
    _same(tv, jv)
    _same(tsub, jsub)
    v = tv.asnumpy().astype(int)
    count = v[-1]
    assert 1 <= count <= cap - 1 and tsub.shape == (count, count)
    assert v[0] == seeds[0] and (v[count:-1] == -1).all()


def test_two_seed_arrays_give_two_samples_as_jax():
    jg, tg = _graphs()
    kw = dict(num_hops=2, num_neighbor=2, max_num_vertices=6, seed=1)
    (ja, ta), (jb, tb) = _ids(0), _ids(3)
    j = jcontrib.dgl_csr_neighbor_uniform_sample(jg, ja, jb, **kw)
    t = tcontrib.dgl_csr_neighbor_uniform_sample(tg, ta, tb, **kw)
    assert len(j) == len(t) == 4
    for a, b in zip(t, j):
        _same(a, b)


@pytest.mark.parametrize("prob", [(1.0, 1.0, 0.0, 0.0, 0.0),
                                  (0.5, 0.1, 0.9, 0.3, 0.7),
                                  (0.0, 0.0, 0.0, 0.0, 0.0)])
def test_non_uniform_sample_matches_jax(prob):
    jg, tg = _graphs()
    jp, tp = _ids(*prob)
    js, ts = _ids(0)
    kw = dict(num_hops=2, num_neighbor=2, max_num_vertices=10, seed=0)
    jv, jsub = jcontrib.dgl_csr_neighbor_non_uniform_sample(jg, jp, js, **kw)
    tv, tsub = tcontrib.dgl_csr_neighbor_non_uniform_sample(tg, tp, ts, **kw)
    _same(tv, jv)
    _same(tsub, jsub)
    if prob[2] == 0.0 and prob[0] == 1.0:
        v = tv.asnumpy().astype(int)
        assert set(v[:v[-1]].tolist()) <= {0, 1}


@pytest.mark.parametrize("sizes", [True, False])
def test_graph_compact_matches_jax(sizes):
    jg, tg = _graphs()
    js, ts = _ids(0)
    kw = dict(num_hops=1, num_neighbor=2, max_num_vertices=10, seed=0)
    jv, jsub = jcontrib.dgl_csr_neighbor_uniform_sample(jg, js, **kw)
    tv, tsub = tcontrib.dgl_csr_neighbor_uniform_sample(tg, ts, **kw)
    count = int(tv.asnumpy()[-1])
    extra = {"graph_sizes": [count]} if sizes else {}
    (j,) = jcontrib.dgl_graph_compact(jsub, jv, **extra)
    (t,) = tcontrib.dgl_graph_compact(tsub, tv, **extra)
    _same(t, j)
    assert t.shape == (count, count)
    # a 0/1 graph compacts to an ordinary CSR, as in the JAX package
    (j01,) = jcontrib.dgl_graph_compact(jcontrib.dgl_adjacency(jg), jv,
                                        graph_sizes=[3])
    (t01,) = tcontrib.dgl_graph_compact(tcontrib.dgl_adjacency(tg), tv,
                                        graph_sizes=[3])
    _same(t01, j01)


def test_edge_ids_exact_past_2_24():
    """64-bit edge ids survive the ops exactly: float32 rounds 16777217
    to 16777216 (``tests/test_advice_fixes.py``)."""
    big = float(2 ** 24 + 1)
    data = onp.asarray([big, big + 2, big + 4, big + 6], onp.float64)
    indices = onp.asarray([1, 0, 2, 1], onp.int64)
    indptr = onp.asarray([0, 1, 3, 4], onp.int64)
    jg = jsp.CSRNDArray.from_host(data, indices, indptr, (3, 3))
    tg = sp.CSRNDArray.from_host(data, indices, indptr, (3, 3))
    ju, tu = _ids(0, 1)
    jv, tv = _ids(1, 2)
    out = tcontrib.edge_id(tg, tu, tv)
    _same(out, jcontrib.edge_id(jg, ju, jv))
    assert out.asnumpy()[0] == big and out.asnumpy()[1] == big + 4
    dense = tg.asnumpy()
    assert dense.dtype == onp.float64 and dense[0, 1] == big
    jall, tall = _ids(0, 1, 2)
    _, jm = jcontrib.dgl_subgraph(jg, jall, return_mapping=True)
    _, tm = tcontrib.dgl_subgraph(tg, tall, return_mapping=True)
    _same(tm, jm)
    assert tm.indices.asnumpy().dtype == onp.int64
    assert tg.copy().asnumpy()[0, 1] == big
    row01 = tg.slice(0, 2)
    assert row01.data.asnumpy()[0] == big
    _same(row01, jg.slice(0, 2))
    _same(tg.slice(-2, 5), jg.slice(-2, 5))


def test_dgl_ops_need_a_csr_graph():
    with pytest.raises(MXNetError, match="CSRNDArray"):
        tcontrib.dgl_adjacency(nd.zeros((3, 3), ctx=CPU))


def test_dgl_names_are_in_the_contrib_namespace():
    for name in ("edge_id", "dgl_adjacency", "dgl_subgraph",
                 "dgl_graph_compact", "dgl_csr_neighbor_uniform_sample",
                 "dgl_csr_neighbor_non_uniform_sample"):
        assert callable(getattr(nd.contrib, name)), name
        assert callable(getattr(jnd.contrib, name)), name
        assert name in tcontrib.__all__


def test_the_smokes_graph_ops_match_jax_on_a_small_graph():
    """``tools/profile_sparse.graph_ops`` (smoke phase 68's code) on a
    seeded graph of 3,000 nodes in both packages: every output bitwise."""
    import mxnet_tpu as jmx

    from mxnet_tpu_torch.tools import profile_sparse as ps

    d, i, p, shape = ps.make_graph(nodes=3000, edges=20000, seed=5)
    assert p[-1] == len(d) == len(i) and (onp.diff(p) >= 0).all()
    tg = sp.csr_matrix((d, i, p), shape=shape, ctx=CPU)
    jg = jsp.CSRNDArray(d, i, p, shape)
    t, _, info = ps.graph_ops(mx, tg, seed=2)
    j, _, jinfo = ps.graph_ops(jmx, jg, seed=2)
    assert info == jinfo and info["sampled_vertices"] > 1024
    assert info["edge_ids_found"] >= 480  # the sources with an edge
    for key in t:
        a, b = t[key], j[key]
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            onp.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype, key

