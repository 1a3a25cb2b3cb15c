"""The deployment chain end to end: programs, bundles, autotune records
and a replica fleet, over the port's serving stack.

The model versions the chain deploys are built here, each from a JSON
spec, so that a fresh process builds the same version the exporter
built (the same weights from the same seed, the same calibration
batches):

- ``{"kind": "symbol", "prefix": ..., "samples": N, "bucket": B}`` — an
  exported symbol graph (``InferenceSession.load``), optimized by the
  graph optimizer (``MXNET_GRAPH_OPT``);
- ``{"kind": "int8_resnet", "model": "resnet50_v1", "batch": B,
  "calib_batches": n, "image": [3, 224, 224], "classes": 1000}`` — a zoo
  model quantized by ``quantize_net_graph`` (naive calibration over
  ``profile_quant.calib_batches``) and hybridized;
- ``{"kind": "decode", "cfg": {DecoderBlockLM kwargs}, "seed": s,
  "rows": R, "buckets": [...], "page_tokens": p, "budget": bytes}`` — a
  stateful decode session over a paged state store.

``python -m mxnet_tpu_torch.tools.deploy_chain serve SPEC.json`` is the
child a deployment runs in a fresh process: it imports the bundles the
spec names, builds and warms every model, answers the spec's requests
(inputs from an ``.npz``, outputs to another), optionally re-answers
them under a forced autotune winner, and prints one JSON line: the
``compile_cache``, ``graph_opt`` and ``autotune`` counters, the bundle
imports, and the seconds from the spawn (``spawn_wall`` in the spec, a
``time.time()``) to each model's first response.

:func:`decode_replica` is the fleet's replica factory
(``serving.fleet.spawn_replica("mxnet_tpu_torch.tools.deploy_chain:"
"decode_replica", env={"DEPLOY_CHAIN_SPEC": json})``).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as onp

__all__ = ["build_session", "answer", "greedy_decode", "decode_replica",
           "serve"]


def _ctx(name):
    import mxnet_tpu_torch as mx

    return mx.cpu() if name == "cpu" else mx.gpu(0)


def build_session(spec, ctx):
    """The :class:`~..serving.InferenceSession` of one model spec."""
    from .. import serving

    kind = spec["kind"]
    if kind == "symbol":
        return serving.InferenceSession.load(
            spec["prefix"], input_shapes=[(1, int(spec["samples"]), 1)],
            buckets=[int(spec["bucket"])], ctx=ctx)
    if kind == "int8_resnet":
        from ..contrib.quantization import quantize_net_graph
        from . import profile_quant as pq
        from . import profile_zoo as pz

        image = tuple(spec.get("image", pq.IMAGE))
        model = spec.get("model", "resnet50_v1")
        # a fixed prefix: the weights' names key the calibrated program,
        # and a process's automatic prefixes count its earlier blocks
        net = pz.build(model, ctx, seed=spec.get("seed", pq.SEED),
                       classes=spec.get("classes", pq.CLASSES),
                       prefix=f"{model}_")
        calib = pq.calib_batches(ctx, int(spec["calib_batches"]),
                                 int(spec["batch"]), image=image)
        qb = quantize_net_graph(net, calib_data=calib, calib_mode="naive")
        if spec.get("hybridize", True):
            qb.hybridize()
        return pq.session(qb, int(spec["batch"]), ctx, image=image)
    if kind == "decode":
        import mxnet_tpu_torch as mx
        from ..models import DecoderBlockLM

        mx.random.seed(int(spec["seed"]))
        net = DecoderBlockLM(**spec["cfg"])
        net.initialize(ctx=ctx)
        store = serving.SessionStateStore(
            net.state_row_shapes(), net.state_row_dtypes(),
            max_sessions=int(spec["rows"]),
            byte_budget=int(spec.get("budget", 0)), ttl_s=0,
            pageable=net.state_row_pageable(),
            page_tokens=int(spec.get("page_tokens", 0)), ctx=ctx)
        return serving.InferenceSession(
            net, input_shapes=[(1, 1)], input_dtypes=["int32"],
            state_store=store, buckets=list(spec["buckets"]), ctx=ctx)
    raise ValueError(f"unknown model kind {kind!r}")


def greedy_decode(sess, first, steps):
    """Greedy tokens of ``len(first)`` streams over ``steps`` steps, one
    batch of explicit-state steps (``sess.step``): ``(tokens (n, steps),
    logits (n, steps, vocab))``, step k's logits choosing token k."""
    n = len(first)
    states = [onp.zeros((n,) + s.row_shape, s.dtype)
              for s in sess._state_specs]
    tok = onp.asarray(first, "int32").reshape(n, 1)
    toks, logs = [], []
    for _ in range(int(steps)):
        logits, states = sess.step(tok, states=states)
        logits = logits.asnumpy()
        tok = logits.argmax(-1).astype("int32").reshape(n, 1)
        toks.append(tok[:, 0])
        logs.append(logits)
    return onp.stack(toks, 1), onp.stack(logs, 1)


def answer(sess, spec, x):
    """A model's answer to its request ``x``: the predict's output, or
    for a decode model the greedy tokens and the last logits from first
    tokens ``x``."""
    if spec["kind"] == "decode":
        toks, logits = greedy_decode(sess, x, spec.get("steps", 8))
        return {"tokens": toks, "logits": logits[:, -1]}
    return {"out": sess.predict(x).asnumpy()}


def decode_replica():
    """The fleet's replica factory: the decode session of the spec in
    ``DEPLOY_CHAIN_SPEC`` (JSON: a decode model spec and ``"ctx"``)."""
    spec = json.loads(os.environ["DEPLOY_CHAIN_SPEC"])
    return build_session(spec, _ctx(spec.get("ctx", "gpu")))


def _counters():
    from .. import autotune
    from ..analysis import graph_opt
    from ..utils import compile_cache as cc

    st = cc.compile_cache_stats()
    return {"compile_cache": {k: st[k] for k in (
        "disk_hits", "disk_misses", "disk_writes", "retraces", "captures",
        "kernel_builds", "calibrations")},
        "graph_opt_runs": graph_opt.counters()["graphs_seen"],
        "autotune": autotune.counters()}


def serve(spec):
    """The child's body: see the module docstring. Returns the report."""
    from .. import artifact, autotune

    spawn = float(spec.get("spawn_wall", time.time()))
    ctx = _ctx(spec.get("ctx", "gpu"))
    if spec.get("deterministic"):
        import torch

        # the same cuDNN algorithms as the exporter, for bitwise answers
        torch.backends.cudnn.deterministic = True
    report = {"imports": [artifact.import_bundle(b)
                          for b in spec.get("bundles", ())],
              "models": {}}
    inputs = dict(onp.load(spec["inputs"])) if spec.get("inputs") else {}
    outputs, sessions = {}, {}
    for name, mspec in spec["models"].items():
        t0 = time.time()
        sess = build_session(mspec, ctx)  # warms every bucket
        got = answer(sess, mspec, inputs[name])
        now = time.time()
        report["models"][name] = {
            "ready_s": now - t0, "since_spawn_s": now - spawn,
            "libraries": sess.kernel_libraries()}
        for k, v in got.items():
            outputs[f"{name}/{k}"] = v
        sessions[name] = sess
    report["first_response_s"] = min(
        m["since_spawn_s"] for m in report["models"].values()) \
        if report["models"] else None
    report["counters"] = _counters()
    from ..kernels import _build

    report["launches"] = _build.launch_counts()
    # the tuned winners, forced: an explicit knob for the lowering, a
    # trial for a fusion threshold (which has no knob)
    forced = spec.get("forced") or {}
    for name, force in forced.items():
        mspec = spec["models"][name]
        if force["decision"] == "quantize.lowering":
            os.environ["MXNET_QUANTIZE_LOWERING"] = str(force["choice"])
            try:
                got = answer(build_session(mspec, ctx), mspec,
                             inputs[name])
            finally:
                os.environ.pop("MXNET_QUANTIZE_LOWERING", None)
        else:
            key = tuple(force["key"])
            with autotune.records.trial(force["decision"], key,
                                        force["choice"]):
                got = answer(sessions[name], mspec, inputs[name])
        for k, v in got.items():
            outputs[f"forced/{name}/{k}"] = v
    if spec.get("out"):
        onp.savez(spec["out"], **outputs)
    return report


def main(argv):
    if len(argv) != 2 or argv[0] != "serve":
        raise SystemExit("usage: python -m mxnet_tpu_torch.tools."
                         "deploy_chain serve SPEC.json")
    with open(argv[1]) as f:
        spec = json.load(f)
    report = serve(spec)
    sys.stdout.write(json.dumps(report) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main(sys.argv[1:])
