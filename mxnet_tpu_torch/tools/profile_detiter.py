"""SSD300-VGG16 trained from ``ImageDetIter`` over a detection .rec.

``write_det_records`` writes a synthetic detection .rec in the
reference's ``pack_det`` header form (header width 2, object width 5:
[2, 5, then per object (class, x1, y1, x2, y2)], coordinates in [0, 1]):
seeded JPEG images of random sizes, 1-5 boxes each, each box a
rectangle in its class's color. ``det_iter`` reads it with the
reference's SSD augmentation (``CreateDetAugmenter(data_shape=(3, 300,
300), rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
std=True)``) after seeding Python's ``random`` and numpy's, so one seed
gives the same batches. ``train_from_det_iter`` trains
``profile_ssd``'s network, loss and optimizer from it through
``pipeline.DeviceFeed`` and times it beside the same step fed from one
batch already on the card.

Run on a machine with a card: ``python3 -m
mxnet_tpu_torch.tools.profile_detiter [--steps 10] [--images 256]``.
"""
from __future__ import annotations

import argparse
import json
import os
import random as pyrandom
import statistics
import tempfile
import time

import numpy as onp

SHAPE = (3, 300, 300)
AUG = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
           std=True)
IMAGES, BATCH, STEPS, PROFILED = 256, 32, 10, 3
CLASSES = 20
MAX_BOXES = 5
SIDES = (240, 480)


def write_det_records(path, n=IMAGES, seed=0, sides=SIDES,
                      classes=CLASSES, max_boxes=MAX_BOXES):
    """``n`` seeded JPEG images (each side in ``sides``) with 1 to
    ``max_boxes`` boxes each, into an indexed .rec at ``path`` (and
    ``path``.idx), labels in the ``pack_det`` form. Returns ``path``."""
    from io import BytesIO

    from PIL import Image

    from .. import recordio

    rs = onp.random.RandomState(seed)
    colors = rs.randint(0, 256, (classes, 3))
    w = recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(n):
        H, W = rs.randint(sides[0], sides[1] + 1, 2)
        img = onp.empty((H, W, 3), "uint8")
        img[:] = rs.randint(60, 200, 3)
        label = [2.0, 5.0]
        for _ in range(rs.randint(1, max_boxes + 1)):
            bw, bh = rs.uniform(0.1, 0.6, 2)
            x0, y0 = rs.uniform(0, 1 - bw), rs.uniform(0, 1 - bh)
            cls = rs.randint(classes)
            img[int(y0 * H):int((y0 + bh) * H),
                int(x0 * W):int((x0 + bw) * W)] = colors[cls]
            label += [float(cls), x0, y0, x0 + bw, y0 + bh]
        buf = BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        w.write_idx(i, recordio.pack(
            recordio.IRHeader(0, onp.asarray(label, "float32"), i, 0),
            buf.getvalue()))
    w.close()
    return path


def det_iter(image, rec, batch=BATCH, seed=0, shape=SHAPE, **aug):
    """``image.ImageDetIter`` (either package's ``mx.image``) over ``rec``
    with ``AUG`` (or ``aug``), shuffled, after seeding Python's ``random``
    and numpy's with ``seed``."""
    pyrandom.seed(seed)
    onp.random.seed(seed)
    return image.ImageDetIter(batch, shape, path_imgrec=rec,
                              path_imgidx=rec + ".idx", shuffle=True,
                              **(aug or AUG))


def label_faults(labels):
    """The rows of (B, M, 5) labels that are neither padding (all -1) nor
    a class id >= 0 with its four coordinates in [0, 1]."""
    labels = onp.asarray(labels)
    pad = (labels == -1).all(-1)
    coords = labels[..., 1:5]
    ok = (labels[..., 0] >= 0) & (coords >= 0).all(-1) & \
        (coords <= 1).all(-1)
    return onp.argwhere(~(pad | ok)).tolist()


def train_from_det_iter(rec, steps=STEPS, batch=BATCH, seed=0,
                        profiled=PROFILED):
    """``profile_ssd``'s SSD300 (hybridized, SGD, its loss) trained
    ``steps`` steps from ``det_iter`` through ``DeviceFeed``, then the
    same step on one batch already on the card; the device's idle share
    over ``profiled`` more steps of each. The first batch's labels are
    held bitwise against the same iterator and seed run on the host
    alone. Returns the numbers as a dict."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.train_imagenet_rec import fed_batches

    from . import profile_ssd as ps
    from .profile_resnet import profile_steps

    host_first = det_iter(mx.image, rec, batch, seed).next().label[0]
    host_first = host_first.asnumpy()
    ctx = mx.gpu(0)
    net = ps.build(mx, ctx, seed=seed)
    net.hybridize()
    trainer = ps.make_trainer(mx, net)
    anchor = ps.anchors(mx, ctx)
    it = det_iter(mx.image, rec, batch, seed)
    # the captures first, on a batch already on the card (a capture must
    # not share the card with the feed's copies), at the iterator's
    # label shape
    xs, ys = ps.synthetic_batch(batch, seed=seed)
    x = mx.nd.array(xs, ctx=ctx)
    y = mx.nd.array(ys[:, :it.max_objects], ctx=ctx)
    for _ in range(2):
        ps.train_step(mx, net, trainer, anchor, x, y)
    torch.cuda.synchronize()
    batches = fed_batches(it, ctx)
    losses, secs, waits, faults = [], [], [], []
    first = None
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            xb, yb, wait = next(batches)
            labels = yb.asnumpy()
            if first is None:
                first = labels
            faults += label_faults(labels)
            loss = ps.train_step(mx, net, trainer, anchor, xb, yb)
            losses.append(float(loss.asscalar()))
            secs.append(time.perf_counter() - t0)
            waits.append(wait)

        def fed_step():
            xb, yb, _ = next(batches)
            ps.train_step(mx, net, trainer, anchor, xb, yb)

        prof = profile_steps(fed_step, profiled)
    finally:
        batches.close()

    def device_step():
        ps.train_step(mx, net, trainer, anchor, x, y)

    t0 = time.perf_counter()
    for _ in range(steps):
        device_step()
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof_dev = profile_steps(device_step, profiled)
    step_ms = 1e3 * statistics.mean(secs)
    return {"steps": steps, "batch": batch, "losses": losses,
            "max_objects": it.max_objects,
            "first_labels_equal_host": bool(
                first.shape == host_first.shape
                and onp.array_equal(first, host_first)),
            "label_faults": faults[:8],
            "step_ms": step_ms, "step_ms_median":
                1e3 * statistics.median(secs),
            "images_per_s": batch * 1e3 / step_ms,
            "feed_wait_ms": 1e3 * statistics.mean(waits),
            "device_fed_step_ms": device_ms,
            "device_fed_images_per_s": batch * 1e3 / device_ms,
            "idle_share": prof["device_idle_share"],
            "idle_share_device_fed": prof_dev["device_idle_share"],
            "profiled_wall_ms": prof["wall_ms_per_step"],
            "profiled_wall_ms_device_fed": prof_dev["wall_ms_per_step"],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "device_busy_ms_device_fed": prof_dev["device_busy_ms_per_step"]}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--images", type=int, default=IMAGES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_detiter: needs a CUDA device")
    with tempfile.TemporaryDirectory(prefix="profile_detiter_") as d:
        rec = write_det_records(os.path.join(d, "det.rec"), args.images)
        print(json.dumps(train_from_det_iter(rec, args.steps)))


if __name__ == "__main__":
    main()
