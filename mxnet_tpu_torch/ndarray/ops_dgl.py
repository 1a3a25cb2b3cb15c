"""DGL graph-sampling operators over CSR adjacency matrices.

The PyTorch counterpart of ``mxnet_tpu/ndarray/ops_dgl.py`` (reference:
src/operator/contrib/dgl_graph.cc, CPU-only ops feeding the Deep Graph
Library integration): neighbor sampling (uniform and weighted),
vertex-induced subgraphs, the adjacency, graph compaction and edge-id
lookup. Sampling is pointer-chasing over an irregular CSR structure:
host work in the reference and in the JAX package, and host work here
(numpy over the CSR arrays). A graph on the card is copied to the host
once per call.

The JAX package's conventions are kept:

- a sampler's vertex array is padded to ``max_num_vertices`` with -1 and
  carries the vertex count in its last slot;
- a subgraph's mapping CSR holds the parent's edge ids + 1 (0 means "no
  edge");
- edge-id payloads are float64 (exact to 2**53) and stay on the host:
  the vertex arrays and ``edge_id``'s output are float64 CPU arrays and
  the id-exact CSRs ``CSRNDArray.from_host`` ones (int64 ids);
- the 0/1 adjacency and subgraph CSRs are ordinary ``CSRNDArray``s
  (float32 values, int32 ids), on the input graph's device.

The samplers draw from ``numpy.random.RandomState(seed)`` in the JAX
package's order, so both packages sample the same vertices.
"""
from __future__ import annotations

import numpy as onp

from ..base import MXNetError
from .ndarray import NDArray, host_tensor

__all__ = ["edge_id", "dgl_adjacency", "dgl_subgraph",
           "csr_neighbor_uniform_sample", "csr_neighbor_non_uniform_sample",
           "dgl_graph_compact"]


def _host(x, dtype):
    """A flat numpy array of ``x`` (an NDArray, a tensor or an
    array-like)."""
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    elif hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return onp.asarray(x, dtype).ravel()


def _host_id_array(arr):
    """A float64 id payload as a CPU NDArray (exact past 2**24)."""
    return NDArray(host_tensor(onp.asarray(arr, onp.float64),
                               dtype="float64"))


def _host_id_csr(data, indices, indptr, shape):
    from .sparse import CSRNDArray

    return CSRNDArray.from_host(onp.asarray(data, onp.float64), indices,
                                indptr, shape)


def _csr_parts(graph):
    """(indptr, indices, data, shape, device) of ``graph`` on the host:
    one copy of each array."""
    from .sparse import CSRNDArray

    if not isinstance(graph, CSRNDArray):
        raise MXNetError("DGL ops expect a CSRNDArray adjacency graph")
    indptr = graph._indptr.cpu().numpy().astype(onp.int64)
    indices = graph._indices.cpu().numpy().astype(onp.int64)
    data = graph._data.detach().cpu().numpy()
    return indptr, indices, data, graph.shape, graph._data.device


def _make_csr(data, indices, indptr, shape, device, dtype=onp.float32):
    from .sparse import CSRNDArray

    return CSRNDArray(host_tensor(onp.asarray(data, dtype)).to(device),
                      onp.asarray(indices, onp.int64),
                      onp.asarray(indptr, onp.int64), shape)


def edge_id(graph, u, v):
    """The edge id (the stored value) of each pair ``(u[i], v[i])``, -1
    where there is no edge (reference: dgl_graph.cc EdgeID)."""
    indptr, indices, data, _, _ = _csr_parts(graph)
    uu, vv = _host(u, onp.int64), _host(v, onp.int64)
    out = onp.full(uu.shape, -1.0, onp.float64)
    for i, (a, b) in enumerate(zip(uu, vv)):
        hit = onp.nonzero(indices[indptr[a]:indptr[a + 1]] == b)[0]
        if hit.size:
            out[i] = data[indptr[a] + hit[0]]
    return _host_id_array(out)


def dgl_adjacency(graph):
    """The same sparsity with every value 1.0 (reference: dgl_graph.cc
    DGLAdjacency)."""
    indptr, indices, data, shape, dev = _csr_parts(graph)
    return _make_csr(onp.ones(data.shape, onp.float32), indices, indptr,
                     shape, dev)


def _induced(indptr, indices, vids):
    """The subgraph induced on ``vids`` (the non-negative ones, in
    order): (parent edge ids + 1, indices, indptr, shape). A vertex
    listed twice keeps its last position, as the JAX package's dict
    does."""
    vids = onp.asarray(vids, onp.int64)
    vids = vids[vids >= 0]
    n = len(vids)
    old2new = onp.full(len(indptr) - 1, -1, onp.int64)
    if n:
        rev = vids[::-1]
        uniq, first = onp.unique(rev, return_index=True)
        old2new[uniq] = n - 1 - first
    starts, lens = indptr[vids], indptr[vids + 1] - indptr[vids]
    offsets = onp.cumsum(lens) - lens
    total = int(lens.sum())
    edges = onp.arange(total, dtype=onp.int64) + onp.repeat(
        starts - offsets, lens)
    new = old2new[indices[edges]]
    keep = new >= 0
    counts = onp.bincount(onp.repeat(onp.arange(n), lens)[keep],
                          minlength=n)
    sub_indptr = onp.concatenate([[0], onp.cumsum(counts)]).astype(onp.int64)
    return ((edges[keep] + 1).astype(onp.float64), new[keep], sub_indptr,
            (n, n))


def dgl_subgraph(graph, *vids, return_mapping=False):
    """The subgraph induced on each vertex array (reference: dgl_graph.cc
    DGLSubgraph): one 0/1 CSR per array, then, with ``return_mapping``,
    one id-exact CSR per array whose values are parent edge ids + 1."""
    indptr, indices, _, _, dev = _csr_parts(graph)
    subs, maps = [], []
    for v in vids:
        d, i, p, shape = _induced(indptr, indices, _host(v, onp.int64))
        subs.append(_make_csr(onp.ones(d.shape, onp.float32), i, p, shape,
                              dev))
        if return_mapping:
            maps.append(_host_id_csr(d, i, p, shape))
    return subs + maps if return_mapping else subs


def _neighbor_sample(graph, seeds, num_hops, num_neighbor,
                     max_num_vertices, probability=None, seed=0):
    indptr, indices, _, _, _ = _csr_parts(graph)
    rng = onp.random.RandomState(seed)
    prob = None if probability is None else _host(probability, onp.float64)
    out = []
    for sd in seeds:
        sv = _host(sd, onp.int64)
        sv = sv[sv >= 0]
        visited = list(dict.fromkeys(int(s) for s in sv))
        frontier = list(visited)
        for _ in range(int(num_hops)):
            nxt = []
            for v in frontier:
                nbrs = indices[indptr[v]:indptr[v + 1]]
                if nbrs.size == 0:
                    continue
                k = min(int(num_neighbor), nbrs.size)
                if prob is not None:
                    p = prob[nbrs]
                    tot = p.sum()
                    if tot <= 0:
                        continue
                    k = min(k, int(onp.count_nonzero(p)))
                    chosen = rng.choice(nbrs, size=k, replace=False,
                                        p=p / tot)
                else:
                    chosen = rng.choice(nbrs, size=k, replace=False)
                nxt.extend(int(c) for c in chosen)
            vset = set(visited)
            fresh = [v for v in dict.fromkeys(nxt) if v not in vset]
            fresh = fresh[:max(0, max_num_vertices - 1 - len(visited))]
            visited.extend(fresh)
            frontier = fresh
            if not frontier:
                break
        visited = visited[:max_num_vertices - 1]
        padded = onp.full((max_num_vertices,), -1, onp.int64)
        padded[:len(visited)] = visited
        padded[-1] = len(visited)  # the count in the last slot
        d, i, p, shape = _induced(indptr, indices,
                                  onp.asarray(visited, onp.int64))
        out.append((_host_id_array(padded.astype(onp.float64)),
                    _host_id_csr(d, i, p, shape)))
    return [v for v, _ in out] + [g for _, g in out]


def csr_neighbor_uniform_sample(graph, *seeds, num_hops=1, num_neighbor=2,
                                max_num_vertices=100, seed=0):
    """Uniform neighborhood sampling from each seed array (reference:
    dgl_graph.cc CSRNeighborUniformSample): the padded vertex arrays,
    then the induced id-exact CSRs (values: parent edge id + 1)."""
    return _neighbor_sample(graph, seeds, num_hops, num_neighbor,
                            max_num_vertices, None, seed)


def csr_neighbor_non_uniform_sample(graph, probability, *seeds, num_hops=1,
                                    num_neighbor=2, max_num_vertices=100,
                                    seed=0):
    """Neighborhood sampling weighted by each vertex's ``probability``
    (reference: dgl_graph.cc CSRNeighborNonUniformSample)."""
    return _neighbor_sample(graph, seeds, num_hops, num_neighbor,
                            max_num_vertices, probability, seed)


def dgl_graph_compact(*graphs_and_vids, return_mapping=False,
                      graph_sizes=None):
    """Padded subgraphs cut to their vertex counts (reference:
    dgl_graph.cc DGLGraphCompact). The arguments are N CSRs then N
    padded vertex arrays (the samplers' outputs); ``graph_sizes`` gives
    the counts, else each vertex array's last slot does."""
    from .sparse import _HostCSRNDArray

    n = len(graphs_and_vids) // 2
    graphs, vid_arrays = graphs_and_vids[:n], graphs_and_vids[n:]
    if graph_sizes is not None:
        sizes = list(graph_sizes)
    else:
        sizes = []
        for v in vid_arrays:
            arr = _host(v, onp.float64)
            sizes.append(int(arr[-1]) if arr.size else 0)
    out = []
    for g, size in zip(graphs, sizes):
        indptr, indices, data, shape, dev = _csr_parts(g)
        k = int(size) if size is not None else shape[0]
        p = indptr[:k + 1]
        d, i = data[:p[-1]], indices[:p[-1]]
        if isinstance(g, _HostCSRNDArray):
            out.append(_host_id_csr(d, i, p, (k, k)))
        else:
            out.append(_make_csr(d, i, p, (k, k), dev, d.dtype))
    return out
