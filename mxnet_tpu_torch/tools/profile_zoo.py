"""A vision-zoo model trained on the card, profiled: the twin of
``tools/profile_resnet.py`` for any ``gluon.model_zoo.vision`` model with
the ``SoftmaxCELoss`` loss and an SGD-momentum ``Trainer`` (no custom
head).

The harness of Simonyan and Zisserman's VGG training (§3.1: SGD with
momentum 0.9, learning rate 0.01, weight decay 5e-4, dropout 0.5 in the
two 4096-wide layers) by default: one fixed synthetic batch of 224 x 224
images (299 x 299 for Inception v3) and class labels drawn from a seed,
Xavier weights from a seed, ``autograd.record``, ``SoftmaxCELoss``,
``backward`` and ``trainer.step(batch)``; ``--hybridize`` captures the
network's forward and backward as CUDA graphs. Run on a machine with one
NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_zoo [--model vgg16] \\
        [--batch 64] [--steps 3] [--hybridize]

It prints one JSON object: the trainable parameter count, host wall ms
per step, img/s, device busy ms per step (the sum of the CUDA kernel and
copy times), the device's idle share, device operations per step, the
device time by kind and of the heaviest operations, and peak memory. It
needs no network and writes nothing. The profiler is
``profile_resnet.profile_steps``.
"""
from __future__ import annotations

import argparse
import json

import numpy as onp
import torch

from .. import autograd, gluon, initializer, nd
from .. import random as mxrandom
from ..context import gpu
from ..gluon.model_zoo import vision
from .profile_resnet import _card, profile_steps

SEED = 0
CLASSES = 1000
LR, MOMENTUM, WD = 0.01, 0.9, 5e-4


def image_size(model):
    return 299 if model.startswith("inception") else 224


def build(model, ctx, seed=SEED, classes=CLASSES, **kwargs):
    """Zoo ``model`` with Xavier weights drawn from ``seed`` on ``ctx``
    (shapes finished by one forward of one image, unrecorded)."""
    mxrandom.seed(seed)
    net = vision.get_model(model, classes=classes, **kwargs)
    net.initialize(initializer.Xavier(), ctx=ctx)
    size = image_size(model)
    shape = (1, size, size, 3) if kwargs.get("layout") == "NHWC" else \
        (1, 3, size, size)
    with autograd.pause():
        net(nd.zeros(shape, ctx=ctx))
    return net


def trainable_count(net):
    """The number of elements of every parameter that takes a
    gradient."""
    return sum(int(onp.prod(p.shape)) for p in net.collect_params().values()
               if p.grad_req != "null")


def synthetic_batch(batch, size, ctx, seed=SEED, classes=CLASSES):
    """One fixed batch from ``seed``: N(0, 1) images (B, 3, size, size)
    and float32 class labels (B,), made on the host with numpy."""
    rs = onp.random.RandomState(seed)
    x = rs.standard_normal((batch, 3, size, size)).astype("float32")
    y = rs.randint(0, classes, batch).astype("float32")
    return nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)


def make_trainer(net, optimizer="sgd", params=None):
    params = params if params is not None else \
        {"learning_rate": LR, "momentum": MOMENTUM, "wd": WD}
    return gluon.Trainer(net.collect_params(), optimizer, dict(params))


def train_step(net, trainer, loss_fn, x, y):
    """Record the forward and the loss, backward, ``step(batch)``;
    returns the batch's mean loss (an NDArray, not synchronized)."""
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss.mean()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vgg16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--hybridize", action="store_true",
                    help="capture the net's forward and backward as CUDA "
                    "graphs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_zoo: needs a CUDA device")
    # full float32 (no TF32), as the parity bounds assume
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = gpu(0)
    net = build(args.model, ctx)
    trainer = make_trainer(net)
    loss_fn = gluon.loss.SoftmaxCELoss()
    if args.hybridize:
        net.hybridize()
    x, y = synthetic_batch(args.batch, image_size(args.model), ctx)
    for _ in range(2):
        loss = train_step(net, trainer, loss_fn, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile_steps(lambda: train_step(net, trainer, loss_fn, x, y),
                         args.steps, top=10)
    del prof["by_name"]
    loss = train_step(net, trainer, loss_fn, x, y)
    print(json.dumps(dict(
        {"card": _card(), "model": args.model, "batch": args.batch,
         "hybridize": args.hybridize, "steps": args.steps,
         "trainable_parameters": trainable_count(net),
         "last_loss": float(loss.asscalar()),
         "img_per_s": args.batch * 1e3 / prof["wall_ms_per_step"],
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}, **prof)))


if __name__ == "__main__":
    main()
