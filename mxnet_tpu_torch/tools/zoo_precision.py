"""Where a zoo model's float32 gradients stand against float64, layer by
layer: the card's and the CPU port's.

One eval-mode forward and backward of ``sum(logits * cotangent)`` at
batch 2, with the weights of ``profile_zoo.build`` (Xavier from a seed)
and an input and a cotangent from a seed, runs three times: on the card
in float64 (the reference), on the card in float32 and on the CPU in
float32. For each layer of ``features`` it prints the relative L2
distance of the gradient with respect to that layer's output, and of the
output itself, from the reference. A max-pool whose window holds two
values within float32 rounding of each other routes its gradient by
each run's rounding, so the distance jumps at that pool's backward and
stays behind it. Run on a machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.zoo_precision [--model vgg16]

It prints one JSON line per layer, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json

import numpy as onp
import torch

from .. import autograd, convert, nd
from ..context import cpu, gpu
from ..gluon.model_zoo import vision
from .profile_resnet import _card
from .profile_zoo import build, image_size

SEED = 20240917


def layer_gradients(name, arrays, x, cot, ctx, dtype):
    """Each ``features`` layer's name, the gradient with respect to its
    output and the output, as float64 host tensors."""
    net = vision.get_model(name, classes=cot.shape[1])
    convert.params_from_numpy(net, arrays, ctx=ctx)
    if dtype != "float32":
        net.cast(dtype)
    h = nd.array(x.astype(dtype), ctx=ctx, dtype=dtype)
    h.attach_grad()  # every layer's output then takes a gradient
    outs, names = [], []
    with autograd.record(train_mode=False):
        for i, blk in enumerate(net.features._children.values()):
            h = blk(h)
            outs.append(h)
            names.append(f"{i}:{type(blk).__name__}")
        loss = (net.output(h) *
                nd.array(cot.astype(dtype), ctx=ctx, dtype=dtype)).sum()
    grads = autograd._torch_grad([loss.data], [o.data for o in outs],
                                 [torch.ones_like(loss.data)],
                                 retain_graph=False)
    return names, [g.detach().double().cpu() for g in grads], \
        [o.data.detach().double().cpu() for o in outs]


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vgg16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("zoo_precision: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    net = build(args.model, gpu(0), seed=SEED)
    arrays = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    del net
    size = image_size(args.model)
    rs = onp.random.RandomState(SEED + 1)
    x = rs.standard_normal((2, 3, size, size)).astype("float32")
    cot = rs.standard_normal((2, 1000)).astype("float32")
    names, ref, ref_out = layer_gradients(args.model, arrays, x, cot, gpu(0),
                                          "float64")
    _, card, card_out = layer_gradients(args.model, arrays, x, cot, gpu(0),
                                        "float32")
    _, host, host_out = layer_gradients(args.model, arrays, x, cot, cpu(),
                                        "float32")
    for i, name in enumerate(names):
        print(json.dumps({
            "model": args.model, "layer": name,
            "grad_card_f32": _rel(card[i], ref[i]),
            "grad_cpu_f32": _rel(host[i], ref[i]),
            "out_card_f32": _rel(card_out[i], ref_out[i]),
            "out_cpu_f32": _rel(host_out[i], ref_out[i])}))
    print(_card())


if __name__ == "__main__":
    main()
