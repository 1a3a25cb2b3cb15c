"""int8 quantized serving of ResNet-50 v1 on the card, against float32.

The port's counterpart of ``mxnet_tpu/benchmark/quant_bench.py``: a
vision-zoo model quantized through the ``quantize_insert`` /
``quantize_elide`` / ``quantize_calibrate`` passes
(``contrib.quantization.quantize_net_graph``) and served through
``InferenceSession.predict`` beside its float32 original. It prints, per
batch size, ms per predict and img/s of the float32 session and of the
int8 one under each lowering (``native``: N2 and ``torch._int_mm``;
``dequant``: float32 cuDNN and cuBLAS on the codes), the weight bytes
each moves per forward, ``accuracy_delta`` (the JAX bench's max
deviation relative to the float32 answer's magnitude) and the launches
of N2 and ``_int_mm`` per predict. Weights are random from a seed and
the calibration data synthetic: no pretrained weights, no dataset.

    python3 -m mxnet_tpu_torch.tools.profile_quant [--batches 1 32]
        [--iters 20] [--calib-batches 4] [--model resnet50_v1]
        [--calib-mode naive|entropy] [--hybridize]

:func:`op_cases` holds the inputs every ``ops_quant`` op is checked on:
``tests/test_torch_quant_ops.py`` runs them against the JAX package,
``chip_smoke.py`` on the card against the CPU port.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as onp

#: ResNet-50 v1's input (He et al., 224 x 224, 1000 ImageNet classes)
IMAGE = (3, 224, 224)
CLASSES = 1000
SEED = 20240917


def op_cases(rs):
    """``[(label, op name, positional numpy args, kwargs)]``: every op of
    ``ops_quant`` on int8 and uint8 inputs, the ranges as (1,) float32
    arrays as the quantized graphs carry them."""
    def f(*s):
        return rs.randn(*s).astype("float32")

    def r(v):
        return onp.array([v], "float32")

    def s8(*s):
        return rs.randint(-127, 128, s).astype("int8")

    q8, u8 = s8(2, 6, 7, 7), rs.randint(0, 256, (2, 6, 7, 7)).astype("uint8")
    acc = rs.randint(-10 ** 6, 10 ** 6, (2, 6, 5, 5)).astype("int32")
    g, b, m = f(6), f(6), f(6)
    v = onp.abs(f(6)) + 0.1
    w = s8(8, 6, 3, 3)
    hist, edges = onp.histogram(onp.abs(rs.randn(5000)), bins=2048)
    return [
        ("quantize int8", "quantize", [f(2, 3, 4, 5), r(-2.5), r(3.1)],
         {"out_type": "int8"}),
        ("quantize uint8", "quantize", [f(2, 3, 4, 5), r(-2.5), r(3.1)],
         {"out_type": "uint8"}),
        ("quantize_v2 data range", "quantize_v2", [f(2, 3, 4, 5)], {}),
        ("quantize_v2 calibrated", "quantize_v2", [f(2, 3, 4, 5)],
         {"min_calib_range": -1.7, "max_calib_range": 2.2}),
        ("quantize_v2 uint8", "quantize_v2", [onp.abs(f(2, 3, 4, 5))],
         {"min_calib_range": 0.0, "max_calib_range": 2.2,
          "out_type": "uint8"}),
        ("dequantize int8", "dequantize", [q8, r(-2.0), r(1.5)], {}),
        ("dequantize uint8", "dequantize", [u8, r(0.0), r(3.0)], {}),
        ("requantize", "requantize", [acc, r(-40.0), r(40.0)], {}),
        ("requantize calibrated", "requantize", [acc, r(-40.0), r(40.0)],
         {"min_calib_range": -0.05, "max_calib_range": 0.04}),
        ("act int8", "_contrib_quantized_act", [q8, r(-2.0), r(2.0)], {}),
        ("act uint8", "_contrib_quantized_act", [u8, r(0.0), r(2.0)], {}),
        ("flatten", "_contrib_quantized_flatten", [q8, r(-2.0), r(2.0)], {}),
        ("max pool int8", "_contrib_quantized_pooling",
         [q8, r(-2.0), r(2.0)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "pool_type": "max"}),
        ("avg pool int8", "_contrib_quantized_pooling",
         [q8, r(-2.0), r(2.0)],
         {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
          "pool_type": "avg"}),
        ("global avg pool uint8", "_contrib_quantized_pooling",
         [u8, r(0.0), r(2.0)],
         {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"}),
        ("add int8", "_contrib_quantized_elemwise_add",
         [q8, q8[::-1].copy(), r(-2.0), r(1.0), r(-0.5), r(3.0)], {}),
        ("add uint8 int8", "_contrib_quantized_elemwise_add",
         [u8, q8, r(0.0), r(1.0), r(-0.5), r(3.0)], {}),
        ("concat", "_contrib_quantized_concat",
         [q8, u8, q8, r(-2.0), r(0.0), r(-1.0), r(2.0), r(3.0), r(1.0)],
         {"dim": 1}),
        ("batch_norm int8", "_contrib_quantized_batch_norm",
         [q8, g, b, m, v, r(-2.0), r(2.0)], {"eps": 1e-5}),
        ("batch_norm uint8 calibrated", "_contrib_quantized_batch_norm",
         [u8, g, b, m, v, r(0.0), r(2.0)],
         {"eps": 1e-3, "fix_gamma": True, "min_calib_range": -3.0,
          "max_calib_range": 2.5}),
        ("conv int8 bias stride pad", "_contrib_quantized_conv",
         [q8, w, r(-2.0), r(2.0), r(-0.3), r(0.3), f(8)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "num_filter": 8}),
        ("conv uint8", "_contrib_quantized_conv",
         [u8, w, r(0.0), r(2.0), r(-0.3), r(0.3)],
         {"kernel": (3, 3), "num_filter": 8, "no_bias": True}),
        ("conv grouped dilated", "_contrib_quantized_conv",
         [q8, s8(8, 3, 3, 3), r(-2.0), r(2.0), r(-0.3), r(0.3)],
         {"kernel": (3, 3), "num_filter": 8, "num_group": 2,
          "dilate": (2, 2), "pad": (2, 2), "no_bias": True}),
        ("conv stem 7x7 C=3", "_contrib_quantized_conv",
         [s8(2, 3, 23, 23), s8(4, 3, 7, 7), r(-2.0), r(2.0), r(-0.3),
          r(0.3), f(4)],
         {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
          "num_filter": 4}),
        ("fc int8 bias", "_contrib_quantized_fully_connected",
         [s8(3, 20), s8(7, 20), r(-1.0), r(1.0), r(-0.2), r(0.2), f(7)],
         {"num_hidden": 7}),
        ("fc uint8 flatten", "_contrib_quantized_fully_connected",
         [u8, s8(7, 6 * 49), r(0.0), r(1.0), r(-0.2), r(0.2)],
         {"num_hidden": 7, "no_bias": True}),
        ("batch_dot", "_contrib_quantized_batch_dot",
         [s8(2, 3, 8), s8(2, 8, 5), r(-1.0), r(1.0), r(-2.0), r(2.0)], {}),
        ("batch_dot transpose_b uint8", "_contrib_quantized_batch_dot",
         [rs.randint(0, 256, (2, 3, 8)).astype("uint8"), s8(2, 5, 8),
          r(0.0), r(1.0), r(-2.0), r(2.0)], {"transpose_b": True}),
        ("calibrate_entropy", "calibrate_entropy",
         [hist.astype("float32"), edges.astype("float32")], {}),
    ]


def resnet50_convolutions(batch):
    """Every convolution of ``resnet50_v1`` at ``batch`` 224 x 224
    images, in forward order: ``[(x shape, w shape, stride, pad)]``
    (dilation 1, one group)."""
    convs = [((batch, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3))]
    c, hw = 64, 56
    for width, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                                  (512, 3, 2)):
        out = width * 4
        for i in range(blocks):
            s = stride if i == 0 else 1
            ohw = hw // s
            convs.append(((batch, c, hw, hw), (width, c, 1, 1), (s, s),
                          (0, 0)))
            convs.append(((batch, width, ohw, ohw), (width, width, 3, 3),
                          (1, 1), (1, 1)))
            convs.append(((batch, width, ohw, ohw), (out, width, 1, 1),
                          (1, 1), (0, 0)))
            if i == 0:
                convs.append(((batch, c, hw, hw), (out, c, 1, 1), (s, s),
                              (0, 0)))
            c, hw = out, ohw
    return convs


def calib_batches(ctx, n, batch, image=IMAGE, seed=SEED):
    """``n`` synthetic calibration batches of ``batch`` N(0, 0.5^2)
    images from ``seed`` (one RandomState per batch, as the JAX bench
    draws them), made on the host and copied to ``ctx``."""
    from .. import nd

    return [nd.array(onp.random.RandomState(seed + i).randn(
        batch, *image).astype("float32") * 0.5, ctx=ctx) for i in range(n)]


def weight_bytes(block):
    """Bytes of the parameters a forward reads (each read once)."""
    return sum(int(p.data().size) * onp.dtype(p.data().dtype).itemsize
               for p in block.collect_params().values())


def accuracy_delta(out, ref):
    """The JAX bench's accuracy delta: the largest deviation from the
    float32 answer, relative to that answer's largest magnitude."""
    out = onp.asarray(out, dtype="float64")
    ref = onp.asarray(ref, dtype="float64")
    return float(onp.abs(out - ref).max() / (onp.abs(ref).max() + 1e-9))


def session(block, batch, ctx, image=IMAGE):
    from .. import serving

    return serving.InferenceSession(block, input_shapes=[(1,) + image],
                                    buckets=[batch], ctx=ctx)


def time_predicts(sess, x, iters):
    """Host ms per ``predict`` over ``iters`` calls after one warm-up
    (each call waits for the device: ``predict`` synchronizes) and the
    last output as a host array."""
    out = sess.predict(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sess.predict(x)
    return (time.perf_counter() - t0) / iters * 1e3, out.asnumpy()


def launches_per_predict(sess, x):
    """``{kernel: launches}`` of one ``predict``."""
    from ..kernels import _build

    sess.predict(x)
    _build.reset_launch_counts()
    sess.predict(x)
    return _build.launch_counts()


def quantized_counts(block):
    """(quantized convolutions, quantized fully connected layers) of a
    quantized ``SymbolBlock``'s graph."""
    nodes = {s._eval_key(): s._op for s in block._outputs._walk()
             if s._op is not None}
    ops = list(nodes.values())
    return (ops.count("_contrib_quantized_conv"),
            ops.count("_contrib_quantized_fully_connected"))


def _kind(name):
    """The layer a device operation of an int8 forward belongs to."""
    from .profile_resnet import _kind as resnet_kind

    low = name.lower()
    if "int8_conv_kernel" in name:
        return "n2_int8_conv"
    if "s8" in low and "gemm" in low or "imma" in low:
        return "int_mm"
    if "reduce" in low:
        return "reduction"
    return resnet_kind(name)


def breakdown(sess, x, steps=3):
    """Device time of ``steps`` predicts of ``sess`` on ``x`` under
    ``torch.profiler``: wall and busy ms per predict, the idle share and
    the device ms by kind (N2, ``_int_mm``, cuDNN, elementwise...)."""
    import collections

    from .profile_resnet import profile_steps

    sess.predict(x)
    prof = profile_steps(lambda: sess.predict(x), steps, top=8)
    by_kind = collections.defaultdict(lambda: [0.0, 0])
    for name, (us, cnt) in prof.pop("by_name").items():
        by_kind[_kind(name)][0] += us
        by_kind[_kind(name)][1] += cnt
    prof["device_ms_per_step_by_kind"] = {
        k: {"ms": us / 1e3 / steps, "per_step": cnt / steps}
        for k, (us, cnt) in sorted(by_kind.items(), key=lambda kv: -kv[1][0])}
    return prof


def run(ctx, model="resnet50_v1", batches=(1, 32), iters=20,
        calib_batches_n=4, calib_batch=32, calib_mode="naive",
        hybridize=False):
    """Quantize ``model`` (``quantize_net_graph``, ``calib_mode``) and
    serve it beside float32 at each batch size under each lowering,
    eagerly or ``hybridize``d (each block's forward captured as a CUDA
    graph per batch size). Returns the report as a dict."""
    import os

    from ..contrib.quantization import quantize_net_graph
    from .profile_zoo import build

    net = build(model, ctx, seed=SEED, classes=CLASSES)
    calib = calib_batches(ctx, calib_batches_n, calib_batch)
    t0 = time.perf_counter()
    qb = quantize_net_graph(net, calib_data=calib, calib_mode=calib_mode)
    calib_s = time.perf_counter() - t0
    convs, fcs = quantized_counts(qb)
    if hybridize:
        net.hybridize()
        qb.hybridize()
    report = {"model": model, "calib_mode": calib_mode,
              "hybridized": bool(hybridize),
              "calib_batches": calib_batches_n, "calib_batch": calib_batch,
              "calibration_s": calib_s, "quantized_convolutions": convs,
              "quantized_fc": fcs,
              "weights": {"fp32_bytes": weight_bytes(net),
                          "int8_bytes": weight_bytes(qb)},
              "results": []}
    report["weights"]["reduction_x"] = \
        report["weights"]["fp32_bytes"] / report["weights"]["int8_bytes"]
    saved = os.environ.get("MXNET_QUANTIZE_LOWERING")
    try:
        for batch in batches:
            x = onp.random.RandomState(11).randn(
                batch, *IMAGE).astype("float32") * 0.5
            fs = session(net, batch, ctx)
            fp32_ms, ref = time_predicts(fs, x, iters)
            row = {"batch": batch, "fp32_ms": fp32_ms,
                   "fp32_img_per_s": batch * 1e3 / fp32_ms}
            for lw in ("native", "dequant"):
                os.environ["MXNET_QUANTIZE_LOWERING"] = lw
                qs = session(qb, batch, ctx)
                ms, out = time_predicts(qs, x, iters)
                row[lw] = {"ms": ms, "img_per_s": batch * 1e3 / ms,
                           "speedup": fp32_ms / ms,
                           "accuracy_delta": accuracy_delta(out, ref),
                           "launches": launches_per_predict(qs, x)}
            report["results"].append(row)
    finally:
        if saved is None:
            os.environ.pop("MXNET_QUANTIZE_LOWERING", None)
        else:
            os.environ["MXNET_QUANTIZE_LOWERING"] = saved
    return report


def main(argv=None):
    from .. import gpu

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="resnet50_v1")
    p.add_argument("--batches", type=int, nargs="+", default=[1, 32])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--calib-mode", default="naive",
                   choices=("naive", "entropy"))
    p.add_argument("--hybridize", action="store_true",
                   help="serve both blocks as captured CUDA graphs")
    a = p.parse_args(argv)
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    print(json.dumps(run(gpu(0), a.model, a.batches, a.iters,
                         a.calib_batches, calib_mode=a.calib_mode,
                         hybridize=a.hybridize), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
