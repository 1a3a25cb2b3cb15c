"""SSD300-VGG16 trained and run on the card, profiled.

The network, its anchors, targets, loss and detection head, defined
once for either package's ``mx`` (``build_ssd300(mx, ...)`` and the
functions beside it use only ``mx.gluon``, ``mx.nd`` and ``mx.init``
names both have), so a test builds the same network in the JAX package
and in the port. The configuration is Liu et al. 2016, "SSD: Single Shot
MultiBox Detector" (arXiv:1512.02325, §2.2-§3), with the 300 x 300 VGG-16
settings of MXNet's ``example/ssd/symbol/symbol_factory.py``:

- input 3 x 300 x 300, 20 classes and the background;
- ``vgg16_reduced``: VGG-16's 13 3x3 convolutions (pad 1; 64-64,
  128-128, 256 x 3, 512 x 3, 512 x 3) with ReLU, ``pool3`` 2x2/2 with
  ``pooling_convention="full"`` (75 → 38), ``pool5`` 3x3/1 pad 1,
  ``fc6`` a 3x3 convolution with dilation 6, pad 6 and 1024 channels,
  ``fc7`` a 1x1 convolution with 1024;
- ``conv4_3`` through ``L2Normalization(mode="channel")`` times a learned
  per-channel scale initialized to 20 (weight decay x 0.1);
- the extra layers 1x1/256 → 3x3/2 pad 1 → 512, 1x1/128 → 3x3/2 pad 1 →
  256, and twice 1x1/128 → 3x3/1 pad 0 → 256;
- six sources (38, 19, 10, 5, 3, 1), anchors of ``SIZES``, ``RATIOS``
  and ``STEPS``: 4, 6, 6, 6, 4 and 4 a position, 8732 in all;
- heads: 3x3 pad 1 convolutions, A x 4 for location, A x 21 for class;
- ``MultiBoxTarget`` at overlap 0.5, ``ignore_label=-1``,
  ``negative_mining_ratio=3``, ``negative_mining_thresh=0.5``, variances
  (0.1, 0.1, 0.2, 0.2); the loss (the paper's eq. 1, alpha = 1): softmax
  cross-entropy over the anchors whose target is at least 0 plus
  ``smooth_l1`` over the masked offsets, both over max(1, matched
  anchors), written in ``nd`` ops;
- SGD, momentum 0.9, weight decay 5e-4 (example/ssd's ``train.py``),
  batch 32, float32 (convolutions in ``cudnn_fp32()``), at learning rate
  0.001, GluonCV's ``train_ssd.py`` default for SSD300-VGG16 at batch
  32: example/ssd's 0.004 assumes a pretrained VGG-16, and from the
  initializer it diverges within four steps;
- detection: ``softmax``, then ``MultiBoxDetection`` with
  ``nms_threshold=0.45``, ``nms_topk=400``, ``threshold=0.01``,
  ``force_suppress=False`` (example/ssd's ``demo.py``/``evaluate``).

The body (backbone and heads) is one ``HybridBlock``, hybridized; the
anchors are computed once; the targets and the loss run eagerly under
``record()``. Data: synthetic images N(0, 0.1) with 1-8 boxes each (a
brighter rectangle in one channel per box), labels -1-padded to 16 rows,
from a seed; weights from a seed. Cuts against the paper: synthetic data
for VOC 07+12, no pretrained backbone, no augmentation.

Run on a machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_ssd [--batch 32] [--steps 20]
        [--lr 0.001]

It prints one JSON object: the card, the trainable parameter count, the
anchors, the losses, step ms (host wall, synchronized, over the timed
steps), img/s, the device's busy ms and idle share over three profiled
steps (``profile_resnet.profile_steps``), peak memory, the milliseconds
of ``MultiBoxTarget`` and of the loss within a step (CUDA events), and
the detection ms per batch (the head alone and with the body's forward).
It needs no network and writes nothing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as onp

from .profile_zoo import trainable_count

SEED = 0
CLASSES = 20
IMAGE = 300
SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
         (.88, .961))
RATIOS = ((1, 2, .5),) + ((1, 2, .5, 3, 1. / 3),) * 3 + ((1, 2, .5),) * 2
STEPS = tuple(s / 300 for s in (8, 16, 32, 64, 100, 300))
FEATURE_SIZES = (38, 19, 10, 5, 3, 1)
ANCHORS = 8732
MAX_BOXES = 16
LR, MOMENTUM, WD = 0.001, 0.9, 5e-4
TARGET = dict(overlap_threshold=0.5, ignore_label=-1.0,
              negative_mining_ratio=3.0, negative_mining_thresh=0.5,
              variances=(0.1, 0.1, 0.2, 0.2))
DETECT = dict(nms_threshold=0.45, nms_topk=400, threshold=0.01,
              force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2))
# (channels of the 1x1, channels of the 3x3, its stride, its pad)
EXTRAS = ((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
          (128, 256, 1, 0))


def anchors_per_position():
    return [len(s) + len(r) - 1 for s, r in zip(SIZES, RATIOS)]


def build_ssd300(mx, classes=CLASSES, div=1, **kwargs):
    """The SSD300-VGG16 body of package ``mx``, every backbone and extra
    width divided by ``div`` (the heads keep theirs), uninitialized.
    Called on a batch it returns (class predictions (B, 8732, classes+1),
    location predictions (B, 8732 * 4))."""
    gluon = mx.gluon
    nn = gluon.nn

    def w(c):
        return max(1, c // div)

    def conv(c, k, **kw):
        return nn.Conv2D(w(c), k, activation="relu", **kw)

    class SSD300(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                # conv1_1 .. relu4_3
                self.features = nn.HybridSequential()
                for n, c, pool in ((2, 64, "valid"), (2, 128, "valid"),
                                   (3, 256, "full"), (3, 512, None)):
                    for _ in range(n):
                        self.features.add(conv(c, 3, padding=1))
                    if pool:
                        self.features.add(nn.MaxPool2D(
                            2, 2, ceil_mode=pool == "full"))
                self.scale = self.params.get(
                    "conv4_3_scale", shape=(1, w(512), 1, 1),
                    init=mx.init.Constant(20.0), wd_mult=0.1)
                # pool4 .. relu7
                self.fc7 = nn.HybridSequential()
                self.fc7.add(nn.MaxPool2D(2, 2))
                for _ in range(3):
                    self.fc7.add(conv(512, 3, padding=1))
                self.fc7.add(nn.MaxPool2D(3, 1, padding=1),
                             conv(1024, 3, padding=6, dilation=6),
                             conv(1024, 1))
                self.extras = nn.HybridSequential()
                for c1, c2, stride, pad in EXTRAS:
                    blk = nn.HybridSequential()
                    blk.add(conv(c1, 1),
                            conv(c2, 3, strides=stride, padding=pad))
                    self.extras.add(blk)
                self.cls_heads = nn.HybridSequential()
                self.loc_heads = nn.HybridSequential()
                for a in anchors_per_position():
                    self.cls_heads.add(nn.Conv2D(a * (classes + 1), 3,
                                                 padding=1))
                    self.loc_heads.add(nn.Conv2D(a * 4, 3, padding=1))

        def hybrid_forward(self, F, x, scale):
            f = self.features(x)
            sources = [F.broadcast_mul(F.L2Normalization(f, mode="channel"),
                                       scale)]
            f = self.fc7(f)
            sources.append(f)
            for i in range(len(self.extras)):
                f = self.extras[i](f)
                sources.append(f)
            cls = [F.flatten(F.transpose(self.cls_heads[i](s),
                                         axes=(0, 2, 3, 1)))
                   for i, s in enumerate(sources)]
            loc = [F.flatten(F.transpose(self.loc_heads[i](s),
                                         axes=(0, 2, 3, 1)))
                   for i, s in enumerate(sources)]
            return (F.reshape(F.concat(*cls, dim=1),
                              shape=(0, -1, classes + 1)),
                    F.concat(*loc, dim=1))

    return SSD300(**kwargs)


def initializer(mx):
    """example/ssd's ``train_net.py`` initializer."""
    return mx.init.Xavier(rnd_type="gaussian", factor_type="out", magnitude=2)


def anchors(mx, ctx=None):
    """The 8732 corner anchors (1, 8732, 4), one ``MultiBoxPrior`` per
    source map."""
    nd = mx.nd
    out = [nd.contrib.MultiBoxPrior(nd.zeros((1, 1, f, f), ctx=ctx),
                                    sizes=s, ratios=r, steps=(st, st))
           for f, s, r, st in zip(FEATURE_SIZES, SIZES, RATIOS, STEPS)]
    return nd.concat(*out, dim=1)


def targets(mx, anchor, labels, cls_preds):
    """``MultiBoxTarget`` at the SSD settings: (loc_t, loc_mask, cls_t)."""
    return mx.nd.contrib.MultiBoxTarget(
        anchor, labels, cls_preds.transpose((0, 2, 1)), **TARGET)


def ssd_loss(mx, cls_preds, loc_preds, loc_t, loc_mask, cls_t):
    """The paper's eq. 1 with alpha = 1: softmax cross-entropy over the
    anchors whose target is at least 0 (matched and mined negatives),
    plus smooth L1 over the matched anchors' offsets, both over max(1,
    matched anchors)."""
    nd = mx.nd
    logp = nd.log_softmax(cls_preds, axis=-1)
    ce = -nd.pick(logp, cls_t, axis=-1) * (cls_t >= 0)
    matched = nd.sum(loc_mask) / 4
    denom = nd.maximum(matched, nd.ones_like(matched))
    loc = nd.smooth_l1((loc_preds - loc_t) * loc_mask, scalar=1.0)
    return nd.sum(ce) / denom + nd.sum(loc) / denom


def detect(mx, cls_preds, loc_preds, anchor):
    """``softmax`` then ``MultiBoxDetection`` at example/ssd's settings:
    (B, 8732, 6) rows [class id, score, x1, y1, x2, y2], -1 where
    suppressed."""
    nd = mx.nd
    probs = nd.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
    return nd.contrib.MultiBoxDetection(probs, loc_preds, anchor, **DETECT)


def synthetic_batch(batch, seed=SEED, size=IMAGE, classes=CLASSES):
    """``batch`` images (B, 3, size, size) of N(0, 0.1) noise, each with
    1-8 boxes drawn as a rectangle of +1 in one channel, and their
    labels (B, 16, 5) rows [class, x1, y1, x2, y2] in [0, 1], -1-padded:
    numpy float32, from ``seed``."""
    rs = onp.random.RandomState(seed)
    x = (rs.standard_normal((batch, 3, size, size)) * 0.1).astype("float32")
    labels = -onp.ones((batch, MAX_BOXES, 5), "float32")
    for i in range(batch):
        for k in range(rs.randint(1, 9)):
            bw, bh = rs.uniform(0.1, 0.6, 2)
            x0, y0 = rs.uniform(0, 1 - bw), rs.uniform(0, 1 - bh)
            cls = rs.randint(classes)
            labels[i, k] = [cls, x0, y0, x0 + bw, y0 + bh]
            r0, r1 = int(y0 * size), int((y0 + bh) * size)
            c0, c1 = int(x0 * size), int((x0 + bw) * size)
            x[i, cls % 3, r0:r1, c0:c1] += 1.0
    return x, labels


def make_trainer(mx, net, lr=LR):
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": MOMENTUM,
                             "wd": WD})


def train_step(mx, net, trainer, anchor, x, labels, marks=None):
    """One step: the body's forward, ``MultiBoxTarget`` and the loss
    under ``record()``, ``backward``, ``trainer.step(1)`` (the loss is
    already normalized). Returns the loss (an NDArray, not synchronized).
    ``marks(i)``, if given, is called before the targets (0), before the
    loss (1) and after it (2)."""
    mark = marks or (lambda i: None)
    with mx.autograd.record():
        cls_preds, loc_preds = net(x)
        mark(0)
        loc_t, loc_mask, cls_t = targets(mx, anchor, labels, cls_preds)
        mark(1)
        loss = ssd_loss(mx, cls_preds, loc_preds, loc_t, loc_mask, cls_t)
        mark(2)
    loss.backward()
    trainer.step(1)
    return loss


def build(mx, ctx, seed=SEED, div=1):
    """The body on ``ctx`` with example/ssd's initializer drawn from
    ``seed``, its shapes finished by one unrecorded forward."""
    mx.random.seed(seed)
    net = build_ssd300(mx, div=div)
    net.initialize(initializer(mx), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((1, 3, IMAGE, IMAGE), ctx=ctx))
    return net


class StepTimer:
    """CUDA events at a step's marks (``train_step(marks=...)``): the
    device ms of ``MultiBoxTarget`` and of the loss, and the host ms the
    Python code took issuing them."""

    def __init__(self):
        import torch

        self._torch = torch
        self.events, self.host = [], []

    def marks(self):
        torch = self._torch
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        host = [0.0] * 3

        def mark(i):
            evs[i].record()
            host[i] = time.perf_counter()
        self.events.append(evs)
        self.host.append(host)
        return mark

    def summary(self):
        self._torch.cuda.synchronize()
        ev = self.events
        return {
            "multibox_target_ms": statistics.mean(
                e[0].elapsed_time(e[1]) for e in ev),
            "loss_ms": statistics.mean(e[1].elapsed_time(e[2]) for e in ev),
            "multibox_target_host_ms": statistics.mean(
                (h[1] - h[0]) * 1e3 for h in self.host),
            "loss_host_ms": statistics.mean(
                (h[2] - h[1]) * 1e3 for h in self.host)}


def train(batch=32, steps=20, warmup=2, seed=SEED, profiled=3, net=None,
          lr=LR):
    """Train SSD300 at ``batch`` on the card for ``warmup`` + ``steps``
    steps, hybridized, on one synthetic batch from ``seed``, then profile
    ``profiled`` more. Returns the numbers as a dict, and the net, its
    anchors and the batch. ``net``: a body already built on the card
    (default: built here from ``seed``)."""
    import torch

    import mxnet_tpu_torch as mx

    from .profile_resnet import profile_steps

    if not torch.cuda.is_available():
        raise SystemExit("profile_ssd: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    ctx = mx.gpu(0)
    net = build(mx, ctx, seed=seed) if net is None else net
    net.hybridize()
    anchor = anchors(mx, ctx)
    trainer = make_trainer(mx, net, lr)
    xs, ys = synthetic_batch(batch, seed=seed)
    x, y = mx.nd.array(xs, ctx=ctx), mx.nd.array(ys, ctx=ctx)
    losses, wall = [], []
    timer = StepTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        loss = train_step(mx, net, trainer, anchor, x, y,
                          marks=timer.marks() if i >= warmup else None)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.asscalar()))
    parts = timer.summary()
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_steps(
        lambda: train_step(mx, net, trainer, anchor, x, y), profiled, top=8)
    del prof["by_name"]
    timed = wall[warmup:]
    result = {
        "batch": batch, "steps": steps,
        "trainable_parameters": trainable_count(net),
        "anchors": int(anchor.shape[1]),
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "mean_step_ms": statistics.mean(timed),
        "median_step_ms": statistics.median(timed),
        "img_per_s": batch * 1e3 / statistics.mean(timed),
        "peak_gb": peak, **parts, "profile": prof}
    return result, (net, anchor, x, y)


def detection_times(net, anchor, x, reps=10):
    """Median ms of the detection head (``detect`` on the body's
    outputs) and of the body's forward with it, on batch ``x``, in
    predict mode; and the mean kept detections per image."""
    import torch

    import mxnet_tpu_torch as mx

    head_ms, full_ms = [], []
    with mx.autograd.predict_mode():
        cls_preds, loc_preds = net(x)
        dets = detect(mx, cls_preds, loc_preds, anchor)
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            detect(mx, cls_preds, loc_preds, anchor)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            detect(mx, *net(x), anchor)
            torch.cuda.synchronize()
            head_ms.append((t1 - t0) * 1e3)
            full_ms.append((time.perf_counter() - t1) * 1e3)
    rows = dets.asnumpy()
    return {"detection_head_ms": statistics.median(head_ms),
            "detection_with_forward_ms": statistics.median(full_ms),
            "detections_per_image": float((rows[..., 0] >= 0).sum(1).mean())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=LR,
                    help="SGD learning rate (example/ssd's 0.004 diverges "
                    "from the initializer)")
    args = ap.parse_args(argv)
    from .profile_resnet import _card

    result, (net, anchor, x, _) = train(args.batch, args.steps, lr=args.lr)
    result.update(detection_times(net, anchor, x))
    print(json.dumps(dict({"card": _card()}, **result)))


if __name__ == "__main__":
    main()
