"""ImageNet-style training from a RecordIO file: the record pipeline
(``io.ImageRecordIter``: the dependency engine's IO lane reads each batch
and decodes it, through libjpeg on the host or nvJPEG and the crop
kernel on the card) staged by ``pipeline.DeviceFeed`` into ResNet-50 v1
trained by the hybridized ``gluon.Trainer`` (reference:
example/image-classification/train_imagenet.py, whose data leg is
ImageRecordIter over .rec shards). The twin of
``examples/train_imagenet_rec.py``: with no ``--rec`` a synthetic .rec
of seeded JPEGs is written first (64 distinct images repeated to the
dataset's length, as the JAX example writes them).

On the card the step is the ResNet-50 path of ``tools/profile_resnet``:
bf16 NHWC under AMP, hybridized (CUDA graphs), the ``rtc_softmax`` loss
head whose two kernels (K4) launch once each a step; SGD at the JAX
example's rate (0.05, momentum 0.9).

  python -m mxnet_tpu_torch.examples.train_imagenet_rec \\
      --images 512 --batch 128 --steps 20
  python -m mxnet_tpu_torch.examples.train_imagenet_rec --cpu \\
      --images 16 --batch 4 --image-size 32 --classes 10 --steps 2 \\
      --widths 8,8,16,32,64
"""
import argparse
import os
import tempfile
import time


def synth_rec(path, n, side, classes, seed=0):
    """JPEG-encode ``n`` images (64 distinct ones from ``seed``, repeated)
    into an indexed .rec, as the JAX example's ``synth_rec`` does; the
    port's ``recordio`` writes the same bytes."""
    from io import BytesIO

    import numpy as onp
    from PIL import Image

    from mxnet_tpu_torch import recordio

    rng = onp.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    blobs = []
    for _ in range(min(n, 64)):
        img = Image.fromarray(rng.randint(0, 255, (side, side, 3), "uint8"))
        buf = BytesIO()
        img.save(buf, format="JPEG", quality=90)
        blobs.append(buf.getvalue())
    for i in range(n):
        w.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(i % classes), i, 0),
            blobs[i % len(blobs)]))
    w.close()
    return path


def record_iter(rec, batch, image_size, threads, seed=0):
    """The example's ``ImageRecordIter``: random crops and mirrors, the
    ImageNet mean and std."""
    from mxnet_tpu_torch import io as mxio

    return mxio.ImageRecordIter(
        rec, data_shape=(3, image_size, image_size), batch_size=batch,
        path_imgidx=rec + ".idx", shuffle=True, rand_crop=True,
        rand_mirror=True, mean_r=123.68, mean_g=116.78, mean_b=103.94,
        std_r=58.4, std_g=57.1, std_b=57.4, preprocess_threads=threads,
        prefetch_buffer=4, seed=seed)


def build(ctx, classes, widths=None, layout="NCHW", seed=0):
    """ResNet-50 v1 (or, with ``widths``, a narrow ResNet v1 of basic
    blocks [1, 1, 1, 1]) with Xavier weights from ``seed``."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mxrandom.seed(seed)
    if widths is None:
        net = vision.resnet50_v1(classes=classes, layout=layout)
    else:
        net = vision.ResNetV1(vision.BasicBlockV1, [1, 1, 1, 1], widths,
                              classes=classes, thumbnail=True, layout=layout)
    net.initialize(initializer.Xavier(), ctx=ctx)
    return net


def make_trainer(net, lr=0.05):
    """SGD at the JAX example's rate and momentum, ``profile_resnet``'s
    weight decay."""
    from mxnet_tpu_torch import gluon

    return gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4})


def fed_batches(it, ctx=None, layout="NCHW"):
    """(x, y, seconds waited) for ever: ``it``'s batches staged by
    ``DeviceFeed`` onto ``ctx``, pass after pass (the records repeat),
    NHWC when the model's ``layout`` is. Close the generator to stop the
    feed."""
    from mxnet_tpu_torch.pipeline import DeviceFeed

    feed = DeviceFeed(it, device=ctx)
    try:
        while True:
            batches = iter(feed)
            t0 = time.perf_counter()
            for batch in batches:
                x, y = batch.data[0], batch.label[0]
                if layout == "NHWC":
                    x = x.transpose((0, 2, 3, 1))
                yield x, y, time.perf_counter() - t0
                t0 = time.perf_counter()
            feed.reset()
    finally:
        feed.close()


def train(batches, net, trainer, steps):
    """``steps`` steps of ``profile_resnet.train_step`` (the rtc_softmax
    head) over ``batches`` (:func:`fed_batches`). Returns (losses,
    seconds of each step, seconds of each waited on the feed)."""
    import torch

    from mxnet_tpu_torch.tools import profile_resnet as pr

    losses, secs, waits = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        x, y, waited = next(batches)
        losses.append(pr.train_step(net, trainer, x, y))
        if x.data.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        waits.append(waited)
    return [float(v.asscalar()) for v in losses], secs, waits


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rec", default=None, help=".rec path (synthetic if unset)")
    p.add_argument("--images", type=int, default=512)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--threads", type=int, default=os.cpu_count() or 2)
    p.add_argument("--widths", default=None,
                   help="a narrow ResNet v1's widths, e.g. 8,8,16,32,64")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (float32, eager)")
    args = p.parse_args()

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp

    rec = args.rec
    if rec is None:
        rec = os.path.join(tempfile.mkdtemp(prefix="imagenet_rec_"),
                           "train.rec")
        stored = max(args.image_size + args.image_size // 8, 32)
        print(f"writing a synthetic {args.images}-image .rec ({stored}px "
              f"stored, {args.image_size}px trained)")
        synth_rec(rec, args.images, stored, args.classes)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    layout = "NCHW" if args.cpu else "NHWC"
    widths = [int(w) for w in args.widths.split(",")] if args.widths \
        else None
    net = build(ctx, args.classes, widths, layout)
    trainer = make_trainer(net)
    if not args.cpu:
        amp.init("bfloat16")
        amp.init_trainer(trainer)
        net.hybridize()
        # the CUDA graphs are captured before the decode threads start: a
        # capture must not share the card with their work (warmup runs on
        # zeros and restores every state)
        size = args.image_size
        trainer.warmup(shapes=[(args.batch, size, size, 3)], block=net)
    it = record_iter(rec, args.batch, args.image_size, args.threads)
    print(f"decoder: {it.decoder}")
    batches = fed_batches(it, ctx, layout)
    try:
        losses, secs, waits = train(batches, net, trainer, args.steps)
    finally:
        batches.close()
        if not args.cpu:
            amp.disable()
        it.close()
    timed = secs[1:] or secs
    ms = 1e3 * sum(timed) / len(timed)
    print(f"steps={len(losses)} loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{ms:.2f} ms a step, {args.batch * 1e3 / ms:.1f} images/s "
          f"(feed wait {1e3 * sum(waits[1:]) / max(len(waits) - 1, 1):.2f} "
          f"ms a step)")


if __name__ == "__main__":
    main()
