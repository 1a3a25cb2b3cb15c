"""ResNet-50 v1 from ``Estimator.fit`` through ONNX to a served batch.

The interchange flow of an MXNet 1.5 user, through the port's entry
points, in four steps:

1. :func:`fit` trains a hybridized zoo network with
   ``gluon.contrib.estimator.Estimator.fit`` (``LoggingHandler``,
   ``CheckpointHandler``, ``EarlyStoppingHandler`` and an ``mx.Monitor``
   that collects every ``interval``-th step) and :func:`hand_loop` trains
   a twin from the same start with the same Trainer settings, loss,
   batches and monitor, written out by hand; the parameters after them
   must be bitwise equal (:func:`same_parameters`);
2. :func:`export` writes the trained block with ``export`` and then
   ``contrib.onnx.export_model``; :func:`check_initializers` reads the
   file back with the package's codec and holds every initializer
   bitwise against its parameter;
3. :func:`import_both` reads the file with ``import_to_gluon`` (a
   hybridized ``SymbolBlock``) and with ``import_model``, bound through
   the ``Executor``;
4. :func:`store_load` stages the exported ``.params`` file in the model
   store's layout under a run-local checksum and loads it through the
   zoo constructor's ``pretrained=True``.

Weights come from a numpy seed, data from another, all on the device
asked for. ``python3 -m mxnet_tpu_torch.tools.profile_onnx`` runs the
flow at ResNet-50 v1's published widths (1000 classes, 224 x 224,
batch 32) on the card and prints one JSON line; ``chip_smoke.py``
phases 69-72 run the same functions with their gates. The tests run
them on the CPU at a toy size.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import tempfile
import time

import numpy as onp

NAME, CLASSES, SIZE, BATCH = "resnet50_v1", 1000, 224, 32
EPOCHS, BATCHES = 2, 4
INTERVAL = 4  # the monitor collects steps 0, 4, ...
PREFIX = "resnet50_"
LR, MOMENTUM, WD = 0.1, 0.9, 1e-4
PREDICT_REPS = 20


def _mx():
    import mxnet_tpu_torch as mx

    return mx


def build(ctx, seed, name=NAME, classes=CLASSES, size=SIZE, **kwargs):
    """The zoo network ``name`` (explicit ``prefix=``) on ``ctx``, its
    weights drawn from ``numpy.random.RandomState(seed)`` (He-normal
    weights, zero biases and means, unit scales and variances); returns
    the block and the host copy of its start."""
    mx = _mx()
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(name, classes=classes, prefix=PREFIX, **kwargs)
    net.initialize(mx.init.Zero(), ctx=ctx)
    net(mx.nd.zeros((1, 3, size, size), ctx=ctx))  # finish the shapes
    rs = onp.random.RandomState(seed)
    start = {}
    for key, p in sorted(net._collect_params_with_prefix().items()):
        shape = tuple(p.shape)
        kind = key.rsplit(".", 1)[-1]
        if kind in ("gamma", "running_var"):
            v = onp.ones(shape, "float32")
        elif kind in ("beta", "bias", "running_mean"):
            v = onp.zeros(shape, "float32")
        else:
            fan_in = int(onp.prod(shape[1:]))
            v = (rs.standard_normal(shape) *
                 onp.sqrt(2.0 / fan_in)).astype("float32")
        p.set_data(v)
        start[key] = v
    return net, start


def twin(ctx, start, name=NAME, classes=CLASSES, **kwargs):
    """A second network of the same kind holding ``start`` on ``ctx``."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(name, classes=classes, prefix=PREFIX, **kwargs)
    return convert.params_from_numpy(net, start, ctx=ctx)


def batches(ctx, seed, n=BATCHES, batch=BATCH, size=SIZE, classes=CLASSES):
    """``n`` (data, label) pairs made from a numpy seed, on ``ctx``; the
    labels are float class indices (MXNet's convention)."""
    mx = _mx()
    rs = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.standard_normal((batch, 3, size, size)).astype("float32")
        y = rs.randint(0, classes, batch).astype("float32")
        out.append((mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)))
    return out


def trainer(net):
    mx = _mx()
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": LR, "momentum": MOMENTUM,
                             "wd": WD})


def _sync(ctx):
    if ctx.device_type == "gpu":
        import torch

        torch.cuda.synchronize()


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms for the bitwise gates (two runs
    of one network agree only with them), torch's flags restored after."""
    import torch

    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def fit(net, data, ctx, workdir, epochs=EPOCHS, interval=INTERVAL):
    """``Estimator.fit`` over ``data`` (a list of (data, label) pairs, one
    epoch) for ``epochs`` epochs with the logging, checkpoint and
    early-stopping handlers and a monitor; returns what it saw: each
    step's ms from its ``batch_begin`` to its ``batch_end`` (a device sync
    at both; the estimator's metric update and checkpoints fall outside,
    in ``fit_s``), the monitor's rows, the log lines, the checkpoint
    files, the final metrics."""
    import logging

    mx = _mx()
    from mxnet_tpu_torch.gluon.contrib.estimator import (
        BatchBegin, BatchEnd, CheckpointHandler, EarlyStoppingHandler,
        Estimator, LoggingHandler)

    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    metrics=[mx.metric.Accuracy()], trainer=trainer(net))
    mon = mx.Monitor(interval)
    mon.install(net)
    step_ms, rows, starts = [], [], []

    class Steps(BatchBegin, BatchEnd):
        """Opens and closes the monitor's step and times the step."""

        def batch_begin(self, estimator, *args, **kwargs):
            _sync(ctx)
            self.t0 = time.perf_counter()
            starts.append(self.t0)
            mon.tic()

        def batch_end(self, estimator, *args, **kwargs):
            rows.extend(mon.toc())
            _sync(ctx)
            step_ms.append(1e3 * (time.perf_counter() - self.t0))

    ckdir = os.path.join(workdir, "checkpoints")
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("mxnet_tpu_torch.estimator")
    keep, level = Keep(), logger.level
    logger.addHandler(keep)
    logger.setLevel(logging.INFO)
    # Steps last: it closes the monitor after the estimator's step
    handlers = [LoggingHandler(metrics=est.train_metrics),
                CheckpointHandler(ckdir, model_prefix=NAME),
                EarlyStoppingHandler(est.train_metrics[-1], patience=2),
                Steps()]
    try:
        t0 = time.perf_counter()
        est.fit(data, epochs=epochs, event_handlers=handlers)
        _sync(ctx)
        seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(keep)
        logger.setLevel(level)
        mon.uninstall()
    return {"step_ms": step_ms, "cycle_ms": _cycles(starts),
            "monitor_rows": rows, "log_lines": lines,
            "checkpoints": sorted(os.listdir(ckdir)), "fit_s": seconds,
            "metrics": [(n, float(v)) for n, v in
                        (m.get() for m in est.train_metrics)]}


def _cycles(starts):
    """ms from each step's start to the next one's: the step with
    everything the loop does between steps (metrics, checkpoints)."""
    return [1e3 * (b - a) for a, b in zip(starts, starts[1:])]


def hand_loop(net, data, ctx, epochs=EPOCHS, interval=INTERVAL):
    """The same training written out by hand: record, loss, backward,
    ``trainer.step(batch)``, the same monitor ticks; each step's ms."""
    mx = _mx()
    tr = trainer(net)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mon = mx.Monitor(interval)
    mon.install(net)
    step_ms, rows, starts = [], [], []
    t_start = time.perf_counter()
    try:
        for _ in range(epochs):
            for x, y in data:
                _sync(ctx)
                t0 = time.perf_counter()
                starts.append(t0)
                mon.tic()
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(x.shape[0])
                rows.extend(mon.toc())
                _sync(ctx)
                step_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        mon.uninstall()
    return {"step_ms": step_ms, "cycle_ms": _cycles(starts),
            "monitor_rows": rows, "loop_s": time.perf_counter() - t_start}


def same_parameters(a, b):
    """The structural names whose values differ between two blocks, bit
    for bit (running statistics included)."""
    import torch

    pa, pb = a._collect_params_with_prefix(), b._collect_params_with_prefix()
    if sorted(pa) != sorted(pb):
        return sorted(set(pa) ^ set(pb))
    return [k for k in sorted(pa) if not torch.equal(
        pa[k].data().data, pb[k].data().data.to(pa[k].data().data.device))]


def export(net, workdir, data_shape):
    """``net.export`` then ``export_model`` at ``data_shape``; the ONNX
    file's path and its sizes and times."""
    from mxnet_tpu_torch.contrib import onnx
    from mxnet_tpu_torch.contrib.onnx import _wire

    prefix = os.path.join(workdir, NAME)
    t0 = time.perf_counter()
    net.export(prefix)
    block_s = time.perf_counter() - t0
    path = os.path.join(workdir, NAME + ".onnx")
    t0 = time.perf_counter()
    onnx.export_model(prefix + "-symbol.json", prefix + "-0000.params",
                      tuple(data_shape), onnx_file_path=path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        model = _wire.ModelProto.FromString(f.read())
    read_s = time.perf_counter() - t0
    return path, prefix + "-0000.params", model, {
        "onnx_bytes": os.path.getsize(path),
        "nodes": len(model.graph.node),
        "initializers": len(model.graph.initializer),
        "opset": model.opset_import[0].version,
        "block_export_s": block_s, "export_s": export_s,
        "codec_read_s": read_s}


def check_initializers(model, net):
    """Every parameter of ``net`` is an initializer of ``model`` (by its
    full name) with the same dtype, shape and bytes; returns how many
    were compared, or raises naming those that differ."""
    inits = {t.name: t for t in model.graph.initializer}
    bad = []
    params = net.collect_params()
    for name, p in params.items():
        t = inits.get(name)
        want = p.data().asnumpy()
        if t is None or t.data_type != 1 or \
                tuple(t.dims) != want.shape or \
                bytes(t.raw_data) != want.tobytes():
            bad.append(name)
    if bad:
        raise RuntimeError(f"ONNX initializers differ from the parameters: "
                           f"{bad[:5]} ({len(bad)} of {len(params)})")
    return len(params)


def import_both(path, ctx, x):
    """The file through ``import_to_gluon`` (hybridized) and through
    ``import_model`` bound by the Executor: each path's logits for
    ``x`` and its seconds, and the block for timing."""
    from mxnet_tpu_torch.contrib import onnx

    t0 = time.perf_counter()
    block = onnx.import_to_gluon(path, ctx=ctx)
    block.hybridize()
    import_s = time.perf_counter() - t0
    gluon_logits = block(x).asnumpy()
    t0 = time.perf_counter()
    sym, args, aux = onnx.import_model(path, ctx=ctx)
    feed = dict(args)
    feed["data"] = x
    exe = sym.bind(ctx=ctx, args=feed, aux_states=aux)
    bind_s = time.perf_counter() - t0
    exe_logits = exe.forward(is_train=False)[0].asnumpy()
    return block, gluon_logits, exe_logits, {
        "import_to_gluon_s": import_s, "import_model_bind_s": bind_s}


def predict_ms(blocks, x, ctx, reps=PREDICT_REPS):
    """Each block's predict of ``x`` timed in turns (blocks in order, then
    reversed), ``reps`` calls a turn after three warm-up calls, each
    call to its outputs' device sync; the ms of every call by block."""
    for b in blocks:
        for _ in range(3):
            b(x)
    _sync(ctx)
    times = {i: [] for i in range(len(blocks))}
    order = list(range(len(blocks)))
    for turn in (order, order[::-1]):
        for i in turn:
            for _ in range(reps):
                t0 = time.perf_counter()
                blocks[i](x)
                _sync(ctx)
                times[i].append(1e3 * (time.perf_counter() - t0))
    return [times[i] for i in order]


def store_load(params_file, root, ctx, name=NAME, **kwargs):
    """Stage ``params_file`` as ``<root>/<name>-<hash>.params`` under a
    run-local checksum of its bytes, load it through the zoo's
    ``pretrained=True`` and restore the checksum table; the net."""
    from mxnet_tpu_torch.gluon.model_zoo import model_store, vision

    with open(params_file, "rb") as f:
        sha = hashlib.sha1(f.read()).hexdigest()
    os.makedirs(root, exist_ok=True)
    shutil.copyfile(params_file, os.path.join(root, f"{name}-{sha[:8]}"
                                              ".params"))
    old = model_store._model_sha1[name]
    model_store._model_sha1[name] = sha
    try:
        return vision.get_model(name, pretrained=True, ctx=ctx, root=root,
                                prefix=PREFIX, **kwargs)
    finally:
        model_store._model_sha1[name] = old


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--hand-first", action="store_true",
                    help="run the hand loop before fit (the first run in "
                    "the process pays its first calls into the libraries)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a toy size: resnet18_v1, "
                    "32 x 32, 10 classes)")
    args = ap.parse_args(argv)
    mx = _mx()
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    kw = dict(name="resnet18_v1", classes=10, size=32) if args.cpu \
        else {}
    size = kw.pop("size", SIZE)
    work = tempfile.mkdtemp(prefix="profile_onnx_")
    try:
        with deterministic():
            net, start = build(ctx, 0, size=size, **kw)
            hand = twin(ctx, start, **kw)
            net.hybridize()
            hand.hybridize()
            data = batches(ctx, 1, batch=args.batch, size=size,
                           classes=kw.get("classes", CLASSES))
            if args.hand_first:
                h = hand_loop(hand, data, ctx)
                f = fit(net, data, ctx, work)
            else:
                f = fit(net, data, ctx, work)
                h = hand_loop(hand, data, ctx)
            differ = same_parameters(net, hand)
            path, params_file, model, ex = export(
                net, work, (args.batch, 3, size, size))
            x = data[0][0]
            _, g, e, im = import_both(path, ctx, x)
            ref = net(x).asnumpy()
            stored = store_load(params_file, os.path.join(work, "models"),
                                ctx, **kw)
            stored.hybridize()
            same = stored(x).asnumpy().tobytes() == ref.tobytes()
        out = dict(ex, **im, fit_step_ms=statistics.median(f["step_ms"]),
                   hand_step_ms=statistics.median(h["step_ms"]),
                   fit_cycle_ms=statistics.median(f["cycle_ms"]),
                   hand_cycle_ms=statistics.median(h["cycle_ms"]),
                   fit_s=f["fit_s"], hand_loop_s=h["loop_s"],
                   hand_first=args.hand_first,
                   fit_equals_hand_loop=not differ,
                   initializers_equal=check_initializers(model, net),
                   gluon_max_abs=float(abs(g - ref).max()),
                   executor_max_abs=float(abs(e - ref).max()),
                   store_logits_bitwise=same)
        print(json.dumps(out))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
