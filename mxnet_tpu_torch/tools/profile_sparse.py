"""Sparse logistic regression and the DGL graph ops on the card.

The workload of the reference's ``example/sparse/linear_classification``
through the port's entry points (``LibSVMIter``, ``nd.sparse``, the
store's sparse push and ``row_sparse_pull``, the lazy optimizer rows),
in two legs over the same CSR batches:

- ``linear``: a logistic regression, ``w`` of shape (features, 1) and a
  bias in the store; each step pulls them, computes the logits
  ``dot(x, w) + b``, pushes ``dot(x, r, transpose_a=True)
  .tostype("row_sparse")`` for the residual ``r = (sigmoid(z) - y) / B``
  and the bias's sum, and pulls the batch's rows with
  ``row_sparse_pull``;
- ``embedding``: the embedding-bag first layer of a wide-and-deep model,
  ``W`` of shape (features, width) in the store, ``z = dot(x, W)``, a
  ``Dense(1)`` head under ``autograd.record()`` with sigmoid
  cross-entropy (its own Trainer), and the row-sparse
  ``dot(x, z.grad, transpose_a=True)`` pushed to the store.

Each leg runs with lazy SGD or lazy Adam. Every function takes either
package's ``mx`` (the JAX one with ``ctx=None``), so the tests hold the
port against the JAX package with the same code. The data is a LibSVM
file written from a seed (:func:`write_libsvm`): each row has ``nnz``
one-hot features of value 1.0, one per field, the field's rank drawn from
a Zipf law (exponent 1.1) and hashed into the feature space, so a
batch's unique columns are skewed as click logs are; labels come from a
fixed seeded weight vector.

``python3 -m mxnet_tpu_torch.tools.profile_sparse`` runs both legs at
avazu-app's width (1,000,000 features, batch 8,192) on the card and
prints one JSON line; ``chip_smoke.py`` phases 66-68 run the same
functions with the CPU comparison.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as onp

FEATURES, BATCH, NNZ, WIDTH = 1_000_000, 8_192, 15, 64
FILE_BATCHES = 40
STEPS = 20
ZIPF = 1.1
LR = {"sgd": 0.1, "adam": 0.01}
# ogbn-arxiv's size (nodes, directed edges); 1,024 seeds over 2 hops
GRAPH_NODES, GRAPH_EDGES = 169_343, 1_166_243
GRAPH_SEEDS, GRAPH_HOPS, GRAPH_FANOUT = 1_024, 2, 10
STAGES = ("batch", "dot", "dot_t", "tostype", "push_update", "pull")


def write_libsvm(path, rows, features=FEATURES, nnz=NNZ, seed=0,
                 zipf=ZIPF):
    """Write ``rows`` LibSVM lines of ``nnz`` one-hot features each (one
    per field; column ``perm[rank * nnz + field]``, ``rank`` Zipf over
    ``features // nnz`` ranks) with 0/1 labels drawn from a seeded
    logistic model. Returns the path."""
    rng = onp.random.RandomState(seed)
    ranks = features // nnz
    p = onp.arange(1, ranks + 1, dtype=onp.float64) ** -zipf
    cdf = onp.cumsum(p / p.sum())
    perm = rng.permutation(features)
    r = onp.minimum(onp.searchsorted(cdf, rng.random_sample((rows, nnz))),
                    ranks - 1)
    cols = onp.sort(perm[r * nnz + onp.arange(nnz)], axis=1)
    w_true = rng.standard_normal(features) / onp.sqrt(nnz)
    logit = w_true[cols].sum(axis=1) - 0.5
    labels = (rng.random_sample(rows) < 1 / (1 + onp.exp(-logit))) \
        .astype(onp.int64)
    onp.savetxt(path, onp.column_stack([labels, cols]),
                fmt=" ".join(["%d"] + ["%d:1"] * nnz))
    return path


def _ctx_kw(ctx):
    return {} if ctx is None else {"ctx": ctx}


class _Stages:
    """Per-stage host times of the timed steps on the card (the card
    waited for at each boundary); a no-op when not timing."""

    def __init__(self, mx, on):
        self.mx, self.on = mx, on
        self.ms = {k: [] for k in STAGES}
        self._t = None

    def start(self):
        if self.on:
            import torch

            torch.cuda.synchronize()
            self._t = time.perf_counter()

    def tick(self, name):
        if self.on:
            import torch

            torch.cuda.synchronize()
            t = time.perf_counter()
            self.ms[name].append(1e3 * (t - self._t))
            self._t = t


def _iter(mx, path, features, batch, ctx):
    return mx.io.LibSVMIter(data_libsvm=path, data_shape=(features,),
                            batch_size=batch, **_ctx_kw(ctx))


def _next(it):
    try:
        return it.next()
    except StopIteration:
        it.reset()
        return it.next()


def _optimizer(mx, opt, rescale=1.0):
    kw = {"lazy_update": True} if opt == "adam" else {}
    return mx.optimizer.create(opt, learning_rate=LR[opt],
                               rescale_grad=rescale, **kw)


class LinearLeg:
    """The logistic regression: the store, the iterator and the buffers
    set up once; :meth:`step` runs one step."""

    def __init__(self, mx, ctx, path, opt, features=FEATURES, batch=BATCH):
        nd = self.nd = mx.nd
        kw = _ctx_kw(ctx)
        self.mx, self.batch = mx, batch
        self.it = _iter(mx, path, features, batch, ctx)
        self.kv = kv = mx.kv.create("local")
        kv.init("w", nd.zeros((features, 1), **kw))
        kv.init("b", nd.zeros((1,), **kw))
        kv.set_optimizer(_optimizer(mx, opt))
        self.w = nd.zeros((features, 1), **kw)
        self.b = nd.zeros((1,), **kw)
        self.rows = nd.zeros((1, 1), **kw)

    def step(self, st):
        """One step (``st``: the stage timer); returns (logits, the
        pushed row-sparse gradient)."""
        nd, kv = self.nd, self.kv
        st.start()
        bt = _next(self.it)
        x, y = bt.data[0], bt.label[0]
        st.tick("batch")
        kv.pull("w", out=self.w)
        kv.pull("b", out=self.b)
        z = nd.sparse.dot(x, self.w).reshape((-1,)) + self.b
        st.tick("dot")
        r = (nd.sigmoid(z) - y) / self.batch
        g = nd.sparse.dot(x, r.reshape((-1, 1)), transpose_a=True)
        st.tick("dot_t")
        g = g.tostype("row_sparse")
        st.tick("tostype")
        kv.push("w", g)
        kv.push("b", r.sum().reshape((1,)))
        st.tick("push_update")
        kv.row_sparse_pull("w", out=self.rows, row_ids=x.indices)
        st.tick("pull")
        return z, g

    def weights(self):
        self.kv.pull("w", out=self.w)
        self.kv.pull("b", out=self.b)
        return [self.w.asnumpy(), self.b.asnumpy()]


def embedding_init(features=FEATURES, width=WIDTH, seed=0):
    """The embedding table and the head's weight and bias, from a seed
    (host arrays)."""
    rng = onp.random.RandomState(seed + 1)
    table = (0.01 * rng.standard_normal((features, width))).astype("f")
    head_w = (rng.standard_normal((1, width)) / onp.sqrt(width)).astype("f")
    return table, head_w, onp.zeros((1,), "f")


class EmbeddingLeg:
    """The embedding-bag layer and its ``Dense(1)`` head, from ``init``
    (:func:`embedding_init`)."""

    def __init__(self, mx, ctx, path, opt, init, features=FEATURES,
                 batch=BATCH):
        nd = self.nd = mx.nd
        gluon = mx.gluon
        kw = _ctx_kw(ctx)
        table, head_w, head_b = init
        width = table.shape[1]
        self.mx, self.batch = mx, batch
        self.it = _iter(mx, path, features, batch, ctx)
        self.kv = kv = mx.kv.create("local")
        kv.init("W", nd.array(table, **kw))
        kv.set_optimizer(_optimizer(mx, opt, rescale=1.0 / batch))
        self.W = nd.zeros((features, width), **kw)
        self.head = head = gluon.nn.Dense(1, in_units=width, prefix="head_")
        head.initialize(**kw)
        head.weight.set_data(head_w)
        head.bias.set_data(head_b)
        self.trainer = gluon.Trainer(head.collect_params(), opt,
                                     {"learning_rate": LR[opt]})
        self.loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        self.rows = nd.zeros((1, width), **kw)

    def step(self, st):
        """One step; returns (the head's logits, the pushed gradient)."""
        nd, kv, autograd = self.nd, self.kv, self.mx.autograd
        st.start()
        bt = _next(self.it)
        x, y = bt.data[0], bt.label[0]
        st.tick("batch")
        kv.pull("W", out=self.W)
        z = nd.sparse.dot(x, self.W)
        z.attach_grad()
        with autograd.record():
            logits = self.head(z)
            loss = self.loss_fn(logits, y.reshape((-1, 1)))
        loss.backward()
        self.trainer.step(self.batch)
        st.tick("dot")
        g = nd.sparse.dot(x, z.grad, transpose_a=True)
        st.tick("dot_t")
        g = g.tostype("row_sparse")
        st.tick("tostype")
        kv.push("W", g)
        st.tick("push_update")
        kv.row_sparse_pull("W", out=self.rows, row_ids=x.indices)
        st.tick("pull")
        return logits.reshape((-1,)), g

    def weights(self):
        self.kv.pull("W", out=self.W)
        return [self.W.asnumpy(), self.head.weight.data().asnumpy(),
                self.head.bias.data().asnumpy()]


def make_leg(mx, leg, ctx, path, opt, features=FEATURES, batch=BATCH,
             init=None):
    if leg == "linear":
        return LinearLeg(mx, ctx, path, opt, features, batch)
    return EmbeddingLeg(mx, ctx, path, opt, init, features, batch)


def run_steps(leg, steps, timed=False, keep=3):
    """``steps`` steps of ``leg``: the first ``keep`` steps' logits and
    pushed row ids (host arrays), the weights after ``keep`` steps and at
    the end, the unique rows a batch, and, when ``timed``, each stage's
    times (the host copies of the first steps fall outside them)."""
    st = _Stages(leg.mx, timed)
    out = {"logits": [], "row_ids": [], "unique_rows": []}
    for s in range(steps):
        z, g = leg.step(st)
        out["unique_rows"].append(g.nnz)
        if s < keep:
            out["logits"].append(z.asnumpy())
            out["row_ids"].append(g.indices.asnumpy())
        if s + 1 == keep:
            out["early_weights"] = leg.weights()
    out["weights"] = leg.weights()
    out["stage_ms"] = st.ms
    return out


def rel_l2(a, b):
    """||a - b|| / ||b|| over two lists of arrays, in float64."""
    num = sum(float(onp.sum((onp.asarray(x, onp.float64)
                             - onp.asarray(y, onp.float64)) ** 2))
              for x, y in zip(a, b))
    den = sum(float(onp.sum(onp.asarray(y, onp.float64) ** 2)) for y in b)
    return (num / den) ** 0.5 if den else num ** 0.5


def compare(card, cpu):
    """The card's run against the CPU's over their common first steps:
    row ids bitwise, the logits' relative L2, and the weights' after the
    steps both kept."""
    n = min(len(card["row_ids"]), len(cpu["row_ids"]))
    return {
        "steps_compared": n,
        "row_ids_equal": all(
            a.shape == b.shape and onp.array_equal(a, b)
            for a, b in zip(card["row_ids"][:n], cpu["row_ids"][:n])),
        "logits_rel_l2": max(rel_l2([a], [b]) for a, b in zip(
            card["logits"][:n], cpu["logits"][:n])),
        "weights_rel_l2": rel_l2(card["early_weights"],
                                 cpu["early_weights"])}


def _stage_summary(stage_ms):
    """Mean ms of each stage over the steps after the first."""
    return {k: statistics.mean(v[1:] if len(v) > 1 else v)
            for k, v in stage_ms.items() if v}


def run_leg(mx, leg, path, opt, steps, features, batch, init=None,
            profiled=5):
    """``leg`` ("linear" or "embedding") on the card: ``steps`` timed
    steps (a sync at each stage boundary), then ``profiled`` more under
    ``torch.profiler`` without the syncs, for the device's idle share,
    and the peak device memory (the process's, and the leg's own above
    what the process held when it began). Returns the run's output and
    its numbers."""
    import torch

    from .profile_resnet import profile_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lg = make_leg(mx, leg, mx.gpu(0), path, opt, features, batch, init)
    t0 = time.perf_counter()
    out = run_steps(lg, steps, timed=True)
    wall = time.perf_counter() - t0
    stages = _stage_summary(out["stage_ms"])
    step_ms = sum(stages.values())
    off = _Stages(mx, False)
    prof = profile_steps(lambda: lg.step(off), profiled)
    numbers = {
        "leg": leg, "optimizer": opt, "features": features, "batch": batch,
        "steps": steps, "wall_s": wall,
        "ms_per_step": step_ms,
        "rows_per_s": batch * 1e3 / step_ms,
        "stage_ms": stages,
        "largest_stage": max(stages, key=stages.get),
        "unique_rows_per_batch": statistics.mean(out["unique_rows"]),
        # the process's peak, and the leg's own above what was held
        # when it started (earlier work in the process still allocated)
        "peak_device_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "leg_peak_gb": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "unsynced_ms_per_step": prof["wall_ms_per_step"],
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "idle_share": prof["device_idle_share"],
        "device_ms_by_kind": {k: v["ms"] for k, v in
                              prof["device_ms_per_step_by_kind"].items()}}
    return out, numbers


def parse_rate(mx, path, features=FEATURES, batch=BATCH):
    """Seconds and rows a second of ``LibSVMIter``'s parse of ``path``
    (the native parser, built first and timed apart), on the CPU side of
    the iterator."""
    from .. import _native

    t0 = time.perf_counter()
    _native.text_lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(features,),
                          batch_size=batch, ctx=mx.cpu())
    s = time.perf_counter() - t0
    return {"rows": it.num_data, "nnz": int(len(it._indices)),
            "parse_s": s, "rows_per_s": it.num_data / s,
            "parser_build_s": build_s}


def make_graph(nodes=GRAPH_NODES, edges=GRAPH_EDGES, seed=0):
    """A seeded directed graph as CSR host arrays (row = source), sorted
    by (source, destination), self loops and duplicates kept; values are
    the edge ids 1..edges."""
    rng = onp.random.RandomState(seed)
    src = rng.randint(0, nodes, edges)
    dst = rng.randint(0, nodes, edges)
    order = onp.lexsort((dst, src))
    indptr = onp.zeros(nodes + 1, onp.int64)
    onp.cumsum(onp.bincount(src, minlength=nodes), out=indptr[1:])
    return (onp.arange(1, edges + 1, dtype=onp.float32), dst[order],
            indptr, (nodes, nodes))


def graph_ops(mx, graph, seed=0):
    """Neighbor sampling of ``GRAPH_SEEDS`` seeds over ``GRAPH_HOPS``
    hops, the subgraph on the sampled vertices (with its mapping) and
    ``edge_id`` of 1,024 pairs (half of them edges) on ``graph``; the
    outputs as host arrays and each op's seconds."""
    nd = mx.nd
    indices, indptr = graph.indices.asnumpy(), graph.indptr.asnumpy()
    rng = onp.random.RandomState(seed + 7)
    n = graph.shape[0]
    seeds = nd.array(rng.choice(n, GRAPH_SEEDS, replace=False)
                     .astype("f"), ctx=mx.cpu())
    cap = 1 + GRAPH_SEEDS * sum(GRAPH_FANOUT ** h
                                for h in range(GRAPH_HOPS + 1))
    times, out = {}, {}
    t0 = time.perf_counter()
    verts, sub = nd.contrib.dgl_csr_neighbor_uniform_sample(
        graph, seeds, num_hops=GRAPH_HOPS, num_neighbor=GRAPH_FANOUT,
        max_num_vertices=cap, seed=seed)
    times["neighbor_sample_s"] = time.perf_counter() - t0
    v = verts.asnumpy()
    count = int(v[-1])
    out["vertices"] = v
    out["sample_csr"] = [sub.data.asnumpy(), sub.indices.asnumpy(),
                         sub.indptr.asnumpy()]
    t0 = time.perf_counter()
    g01, mapping = nd.contrib.dgl_subgraph(
        graph, nd.array(v[:count], ctx=mx.cpu(), dtype="float64"),
        return_mapping=True)
    times["subgraph_s"] = time.perf_counter() - t0
    out["subgraph"] = [g01.data.asnumpy(), g01.indices.asnumpy(),
                       g01.indptr.asnumpy()]
    out["mapping"] = [mapping.data.asnumpy(), mapping.indices.asnumpy(),
                      mapping.indptr.asnumpy()]
    src = rng.randint(0, n, 1024)
    dst = rng.randint(0, n, 1024)
    has = onp.nonzero(indptr[src[:512] + 1] > indptr[src[:512]])[0]
    dst[has] = indices[indptr[src[has]]]  # a real edge for these
    t0 = time.perf_counter()
    eid = nd.contrib.edge_id(graph, nd.array(src.astype("f"), ctx=mx.cpu()),
                             nd.array(dst.astype("f"), ctx=mx.cpu()))
    times["edge_id_s"] = time.perf_counter() - t0
    out["edge_ids"] = eid.asnumpy()
    return out, times, {"sampled_vertices": count,
                        "sample_edges": int(len(out["sample_csr"][0])),
                        "edge_ids_found": int((out["edge_ids"] >= 0).sum())}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--features", type=int, default=FEATURES)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sparse: needs a CUDA device")
    import mxnet_tpu_torch as mx

    with tempfile.TemporaryDirectory(prefix="profile_sparse_") as d:
        path = write_libsvm(os.path.join(d, "train.libsvm"),
                            FILE_BATCHES * args.batch, args.features,
                            seed=args.seed)
        res = {"parse": parse_rate(mx, path, args.features, args.batch)}
        init = embedding_init(args.features, WIDTH, args.seed)
        for leg in ("linear", "embedding"):
            for opt in ("sgd", "adam"):
                _, res[f"{leg}_{opt}"] = run_leg(
                    mx, leg, path, opt, args.steps, args.features,
                    args.batch, init)
        print(json.dumps(res))


if __name__ == "__main__":
    main()
