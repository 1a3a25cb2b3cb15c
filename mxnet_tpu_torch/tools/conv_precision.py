"""How far the card's float32 convolutions sit from a float64 reference.

Runs one eval-mode record/backward of ``resnet18_v1`` (thumbnail, 10
classes, Xavier weights and a 2 x 3 x 32 x 32 batch from a seed) on the
CPU in float64 (the reference), on the CPU in float32, and on the card
in float32 under each combination of torch's global
``cudnn.allow_tf32`` and ``MXNET_CUDNN_AUTOTUNE_DEFAULT``. Prints one
JSON line per run: the deviation of the logits and of three weight
gradients (the 3x3 stem, a block's first convolution, the classifier),
each relative to the reference's largest entry, beside the card's name
and power limit. Then the stem's weight gradient alone, through torch's
``conv2d`` backward with a random output gradient, under cuDNN in the
port's scope, cuDNN with TF32 allowed, cuDNN restricted to deterministic
algorithms, and torch's own CUDA convolution (cuDNN off). Last, a trace
of the same record/backward through every layer of the network: each
layer's output and the gradient reaching it, on the card in float32
(the port's scope) and on the CPU in float32, against float64, with the
count of ReLU outputs that are zero on one side and not on the other
(a ReLU input within float32 noise of zero), and the layer nearest the
output whose gradient on the card leaves float32's accuracy. Run on a
machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.conv_precision

It needs no network and writes nothing.
"""
from __future__ import annotations

import json
import os

import numpy as onp
import torch

from .. import autograd, convert, cpu, gpu, init, nd
from .. import random as mxrandom
from ..gluon import loss as gloss
from ..gluon.model_zoo import vision
from .profile_decode import _card

WATCHED = ("features.0.weight", "features.2.0.body.0.weight",
           "output.weight")


def _run(arrays, x, y, ctx, dtype):
    net = vision.resnet18_v1(thumbnail=True, classes=10)
    for p in net.collect_params().values():
        p.dtype = dtype
    convert.params_from_numpy(
        net, {k: v.astype(dtype) for k, v in arrays.items()}, ctx=ctx)
    xs = nd.array(x, ctx=ctx, dtype=dtype)
    ys = nd.array(y, ctx=ctx, dtype=dtype)
    with autograd.record(train_mode=False):
        logits = net(xs)
        loss = gloss.SoftmaxCrossEntropyLoss()(logits, ys)
    loss.backward()
    params = net._collect_params_with_prefix()
    return [logits.asnumpy().astype("float64")] + [
        params[n].grad().asnumpy().astype("float64") for n in WATCHED]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("conv_precision: needs a CUDA device")
    mxrandom.seed(5)
    rs = onp.random.RandomState(21)
    src = vision.resnet18_v1(thumbnail=True, classes=10)
    src.initialize(init.Xavier(), ctx=cpu())
    x = rs.standard_normal((2, 3, 32, 32)).astype("float32")
    y = rs.randint(0, 10, 2).astype("float32")
    with autograd.pause():
        src(nd.array(x, ctx=cpu()))
    arrays = {k: p.data().asnumpy()
              for k, p in src._collect_params_with_prefix().items()}
    ref = _run(arrays, x, y, cpu(), "float64")
    card = _card()

    def report(name, got):
        dev = {k: float(onp.abs(g - r).max() / onp.abs(r).max())
               for k, g, r in zip(("logits",) + WATCHED, got, ref)}
        print(json.dumps({"card": card, "run": name, "torch":
                          torch.__version__, "deviation": dev}))

    report("cpu float32", _run(arrays, x, y, cpu(), "float32"))
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
             os.environ.get("MXNET_CUDNN_AUTOTUNE_DEFAULT"))
    try:
        for tf32 in (True, False):
            for autotune in ("1", "0"):
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cudnn.benchmark = False
                os.environ["MXNET_CUDNN_AUTOTUNE_DEFAULT"] = autotune
                report(f"card float32, global allow_tf32={tf32}, "
                       f"MXNET_CUDNN_AUTOTUNE_DEFAULT={autotune}",
                       _run(arrays, x, y, gpu(0), "float32"))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = \
            saved[:2]
        if saved[2] is None:
            os.environ.pop("MXNET_CUDNN_AUTOTUNE_DEFAULT", None)
        else:
            os.environ["MXNET_CUDNN_AUTOTUNE_DEFAULT"] = saved[2]
    _stem_alone(arrays["features.0.weight"], x, card)
    _trace_layers(arrays, x, y, card)


def _stem_alone(w, x, card):
    """The stem's weight gradient through torch's conv2d backward under
    four cuDNN settings, against float64 on the CPU."""
    from ..ndarray.ops_nn import cudnn_fp32

    g = onp.random.RandomState(22).standard_normal(
        (x.shape[0], w.shape[0]) + x.shape[2:]).astype("float32")

    def grad(dev, dtype):
        wt = torch.tensor(w, dtype=dtype, device=dev, requires_grad=True)
        out = torch.nn.functional.conv2d(
            torch.tensor(x, dtype=dtype, device=dev), wt, padding=1)
        out.backward(torch.tensor(g, dtype=dtype, device=dev))
        return wt.grad.double().cpu().numpy()

    ref = grad("cpu", torch.float64)
    flags = torch.backends.cudnn.flags
    runs = {"port scope (cuDNN, float32)": cudnn_fp32,
            "cuDNN, allow_tf32": lambda: flags(enabled=True,
                                               allow_tf32=True),
            "cuDNN, deterministic, no TF32": lambda: flags(
                enabled=True, deterministic=True, allow_tf32=False),
            "cuDNN off (torch's CUDA conv)": lambda: flags(enabled=False)}
    for name, scope in runs.items():
        with scope():
            got = grad("cuda", torch.float32)
        print(json.dumps({"card": card, "run": f"stem weight gradient, "
                          f"{name}", "deviation": float(
                              onp.abs(got - ref).max() / onp.abs(ref).max())}))



def _trace(arrays, x, y, ctx, dtype):
    """Every layer's output and the gradient reaching it, in forward
    order, for one eval-mode record/backward (float64 host arrays)."""
    from ..ndarray import NDArray

    net = vision.resnet18_v1(thumbnail=True, classes=10)
    for p in net.collect_params().values():
        p.dtype = dtype
    convert.params_from_numpy(
        net, {k: v.astype(dtype) for k, v in arrays.items()}, ctx=ctx)
    order, acts, grads = [], {}, {}

    def hook(name):
        def fn(_mod, _inputs, out):
            if not isinstance(out, NDArray):
                return
            t = out.data
            order.append(name)
            acts[name] = t.detach().double().cpu().numpy()
            if t.requires_grad:
                t.register_hook(lambda g: grads.__setitem__(
                    name, g.detach().double().cpu().numpy()))
        return fn

    handles = [m.register_forward_hook(hook(n))
               for n, m in net.named_modules() if n]
    try:
        with autograd.record(train_mode=False):
            logits = net(nd.array(x, ctx=ctx, dtype=dtype))
            loss = gloss.SoftmaxCrossEntropyLoss()(
                logits, nd.array(y, ctx=ctx, dtype=dtype))
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    return order, acts, grads


def _trace_layers(arrays, x, y, card):
    order, ref_a, ref_g = _trace(arrays, x, y, cpu(), "float64")
    runs = {"card float32": _trace(arrays, x, y, gpu(0), "float32"),
            "cpu float32": _trace(arrays, x, y, cpu(), "float32")}

    def dev(a, r):
        return float(onp.abs(a - r).max() / (onp.abs(r).max() or 1.0))

    rows, first = [], {}
    for name in order:
        row = {"layer": name}
        for run, (_, acts, grads) in runs.items():
            row[f"{run}: output"] = dev(acts[name], ref_a[name])
            if name in grads and name in ref_g:
                row[f"{run}: gradient"] = dev(grads[name], ref_g[name])
            flips = int(((acts[name] == 0) != (ref_a[name] == 0)).sum())
            if flips:
                row[f"{run}: zero on one side only"] = flips
        rows.append(row)
    # from the output back: the last layer (in forward order) whose
    # gradient on the card is already off by more than 1e-4
    for run in runs:
        bad = [r["layer"] for r in rows
               if r.get(f"{run}: gradient", 0.0) > 1e-4]
        first[run] = bad[-1] if bad else None
    print(json.dumps({"card": card, "run": "layer trace", "layers": rows,
                      "nearest_output_gradient_above_1e-4": first}))


if __name__ == "__main__":
    main()
