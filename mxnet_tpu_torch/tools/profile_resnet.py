"""ResNet-50 v1 training with a runtime-compiled CUDA loss head, profiled.

The path of K4 (``rtc.CudaModule``) on the card: the loss head is a
custom op, ``rtc_softmax``, in the form of MXNet's
``example/numpy-ops/custom_softmax_rtc.py``. Its forward and backward
are CUDA C kernels held here as source strings, compiled at run time by
``rtc.CudaModule`` (NVRTC, ``sm_90a``) and launched through
``CudaKernel.launch``:

- ``rtc_softmax_fwd<DType>``: one block per row of ``data`` (B, C); the
  row's max and then its sum of ``exp(x - max)`` are reduced with warp
  shuffles and a 33-slot shared array; each element is written as
  ``exp(x - max) / sum``. DType float or double, reductions in DType.
- ``rtc_softmax_bwd<DType>``: one block per row; ``dx = p - onehot(label)``
  written into ``in_grad[0]``. The head needs no top gradient
  (``need_top_grad=False``), like MXNet's ``SoftmaxOutput``; with a
  ``grad_scale`` input (a (1,) tensor, as ``SoftmaxOutput``'s
  ``grad_scale``) the gradient is multiplied by it after the kernel —
  the AMP loss scale, which ``Trainer.step`` divides back out.

Both are memory-bound: the forward reads ``x`` once and writes ``p``
once (the second ``exp`` pass re-reads the row from L1/L2), the
backward reads ``p`` and writes ``dx``. Beside each kernel stands its
plain PyTorch version (:func:`softmax_fwd_plain`,
:func:`softmax_bwd_plain`), which a CPU input takes; a CUDA input always
launches the kernels, and nothing catches a kernel's failure.

The training harness is MXNet's ``train_imagenet.py --benchmark 1``:
``resnet50_v1`` at its published widths and depth, 1000 classes,
224 x 224 images of one fixed synthetic batch made from a seed, Xavier
weights from a seed, ``autograd.record``, the ``rtc_softmax`` head,
``backward`` and ``gluon.Trainer`` with SGD (lr 0.1, momentum 0.9,
wd 1e-4, ``step(batch_size)``; the fused step unless
``MXNET_FUSED_STEP=0``). With ``--amp`` it trains under
``amp.init("bfloat16")`` with a loss scaler (``amp.init_trainer``); the
head's kernels are float32, so the bf16 logits are cast to float32
before it, as a user of an fp32-only RTC kernel would do. Run on a
machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_resnet [--batch 128] \
        [--steps 3] [--amp] [--layout NCHW|NHWC] [--hybridize]

``--hybridize`` captures the net's forward and backward as CUDA graphs
(``HybridBlock.hybridize``; the head and the fused step stay as they
are).

It prints one JSON object: host wall ms per step, device busy ms per
step (the sum of the CUDA kernel and copy times), the device's idle
share, device operations per step, the K4 launches per step and their
device time, the device time by kind (convolution, batch norm, the
running statistics' pass, GEMM, K4, dtype casts and copies, layout
transposes, the optimizer's multi-tensor passes, elementwise and other)
and of the heaviest operations. It needs no network and writes
nothing.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import threading
import time

import numpy as onp
import torch

from .. import autograd, gluon, gpu, initializer, nd, operator
from .. import random as mxrandom
from ..contrib import amp
from ..base import MXNetError
from ..ndarray import NDArray
from ..rtc import CudaModule
from ..gluon.model_zoo import vision

__all__ = ["FWD_SRC", "BWD_SRC", "FWD_KERNEL", "BWD_KERNEL",
           "softmax_fwd_plain", "softmax_bwd_plain", "softmax_fwd",
           "softmax_bwd", "rtc_softmax", "build_resnet50", "synthetic_batch",
           "make_trainer", "train_step", "cross_entropy"]

FWD_SRC = r"""
template <class DType> struct SoftmaxMath;
template <> struct SoftmaxMath<float> {
  static __device__ __forceinline__ float lowest() {
    return __int_as_float((int)0xff800000u);  // -inf
  }
  static __device__ __forceinline__ float ex(float v) { return expf(v); }
};
template <> struct SoftmaxMath<double> {
  static __device__ __forceinline__ double lowest() {
    return __longlong_as_double((long long)0xfff0000000000000ull);  // -inf
  }
  static __device__ __forceinline__ double ex(double v) { return exp(v); }
};

// The block's max (kMax) or sum of v: a shuffle tree in each warp, then
// warp 0 over the warps' partials; smem[32] hands the result to all.
template <class DType, bool kMax>
__device__ __forceinline__ DType block_reduce(DType v, DType* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const DType w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? (w > v ? w : v) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane]
        : (kMax ? SoftmaxMath<DType>::lowest() : DType(0));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const DType w = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? (w > v ? w : v) : v + w;
    }
    if (lane == 0) smem[32] = v;
  }
  __syncthreads();
  return smem[32];
}

// y = softmax(x) over each row of C; one block per row, blockDim a
// multiple of 32 (<= 1024). req 1 writes y, req 2 adds to it.
template <class DType>
__global__ void rtc_softmax_fwd(const DType* x, DType* y, const int C,
                                const int req) {
  __shared__ DType smem[33];
  const DType* xr = x + (long long)blockIdx.x * C;
  DType* yr = y + (long long)blockIdx.x * C;
  DType m = SoftmaxMath<DType>::lowest();
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const DType v = xr[i];
    m = v > m ? v : m;
  }
  m = block_reduce<DType, true>(m, smem);
  DType s = DType(0);
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    s += SoftmaxMath<DType>::ex(xr[i] - m);
  s = block_reduce<DType, false>(s, smem);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const DType p = SoftmaxMath<DType>::ex(xr[i] - m) / s;
    if (req == 2) yr[i] += p; else yr[i] = p;
  }
}
"""

BWD_SRC = r"""
// dx = p - onehot(label) over each row of C; one block per row. label
// holds class indices in DType (MXNet's convention); an index outside
// [0, C) subtracts nothing. req 1 writes dx, req 2 adds to it.
template <class DType>
__global__ void rtc_softmax_bwd(const DType* label, const DType* p, DType* dx,
                                const int C, const int req) {
  const int z = static_cast<int>(label[blockIdx.x]);
  const DType* pr = p + (long long)blockIdx.x * C;
  DType* dr = dx + (long long)blockIdx.x * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const DType g = i == z ? pr[i] - DType(1) : pr[i];
    if (req == 2) dr[i] += g; else dr[i] = g;
  }
}
"""

FWD_KERNEL = "rtc_softmax_fwd<float>"
BWD_KERNEL = "rtc_softmax_bwd<float>"
_CTYPE = {torch.float32: "float", torch.float64: "double"}
_REQ_CODE = {"write": 1, "inplace": 1, "add": 2}

# guards: _KERNELS
_LOCK = threading.Lock()
_KERNELS = {}  # ("fwd" | "bwd", C type) -> CudaKernel


def _kernel(which, dtype):
    """The compiled kernel for ``which`` and the tensor dtype; both
    sources are compiled once per process, at first use."""
    ctype = _CTYPE.get(dtype)
    if ctype is None:
        raise MXNetError(f"rtc_softmax: float32 or float64, got {dtype}")
    with _LOCK:
        if not _KERNELS:
            fwd = CudaModule(FWD_SRC, exports=[f"rtc_softmax_fwd<{t}>"
                                               for t in _CTYPE.values()])
            bwd = CudaModule(BWD_SRC, exports=[f"rtc_softmax_bwd<{t}>"
                                               for t in _CTYPE.values()])
            for t in _CTYPE.values():
                _KERNELS["fwd", t] = fwd.get_kernel(
                    f"rtc_softmax_fwd<{t}>",
                    f"const {t}* x, {t}* y, const int C, const int req")
                _KERNELS["bwd", t] = bwd.get_kernel(
                    f"rtc_softmax_bwd<{t}>",
                    f"const {t}* label, const {t}* p, {t}* dx, const int C, "
                    "const int req")
        return _KERNELS[which, ctype]


def _threads(C):
    """Threads per block: whole warps covering the row, at most 512."""
    return min(512, max(32, (C + 31) // 32 * 32))


def softmax_fwd_plain(x):
    """The forward kernel's arithmetic in PyTorch: ``exp(x - max) / sum``
    over the last axis."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def softmax_bwd_plain(label, p):
    """The backward kernel's arithmetic in PyTorch: ``p - onehot(label)``
    (an index outside the row subtracts nothing)."""
    cls = torch.arange(p.shape[-1], device=p.device)
    return p - (cls == label.to(torch.int64)[:, None]).to(p.dtype)


def _check(x, *others):
    if x.dim() != 2:
        raise MXNetError(f"rtc_softmax: data must be (B, C), got "
                         f"{tuple(x.shape)}")
    for t in others:
        if t.dtype != x.dtype or t.device != x.device:
            raise MXNetError(f"rtc_softmax: every input of {x.dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")


def softmax_fwd(x, y, req="write"):
    """``y`` (B, C) gets softmax(``x``) by ``req``: the RTC forward kernel
    on a CUDA tensor, the plain version on a CPU one."""
    _check(x, y)
    if req == "null":
        return
    if x.is_cuda:
        _kernel("fwd", x.dtype).launch(
            [x, y, x.shape[1], _REQ_CODE[req]], _ctx(x), (x.shape[0], 1, 1),
            (_threads(x.shape[1]), 1, 1))
        return
    p = softmax_fwd_plain(x)
    with torch.no_grad():
        if req == "add":
            y.add_(p)
        else:
            y.copy_(p)


def softmax_bwd(label, p, dx, req="write"):
    """``dx`` (B, C) gets ``p - onehot(label)`` by ``req``: the RTC
    backward kernel on CUDA tensors, the plain version on CPU ones."""
    _check(p, label, dx)
    if req == "null":
        return
    if p.is_cuda:
        _kernel("bwd", p.dtype).launch(
            [label, p, dx, p.shape[1], _REQ_CODE[req]], _ctx(p),
            (p.shape[0], 1, 1), (_threads(p.shape[1]), 1, 1))
        return
    g = softmax_bwd_plain(label, p)
    with torch.no_grad():
        if req == "add":
            dx.add_(g)
        else:
            dx.copy_(g)


def _ctx(t):
    return gpu(t.device.index or 0)


class RtcSoftmax(operator.CustomOp):
    """Softmax loss head whose forward and backward are the RTC kernels
    (reference: example/numpy-ops/custom_softmax_rtc.py)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        _check(in_data[0].data, in_data[1].data)
        softmax_fwd(in_data[0].data, out_data[0].data, req[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        softmax_bwd(in_data[1].data, out_data[0].data, in_grad[0].data,
                    req[0])
        if len(in_data) == 3:  # the loss scale, left on the device
            in_grad[0].data.mul_(in_data[2].data)


@operator.register("rtc_softmax")
class RtcSoftmaxProp(operator.CustomOpProp):
    """Inputs ``data`` (B, C) and ``label`` (B,), and with
    ``scaled=True`` a ``grad_scale`` (1,) that multiplies the gradient;
    output the softmax (B, C); no top gradient needed."""

    def __init__(self, scaled="False"):
        super().__init__(need_top_grad=False)
        self._scaled = scaled == "True"

    def list_arguments(self):
        return ["data", "label"] + (["grad_scale"] if self._scaled else [])

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        data_shape = in_shape[0]
        ins = [data_shape, [data_shape[0]]] + ([[1]] if self._scaled else [])
        return ins, [data_shape], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return RtcSoftmax()


def rtc_softmax(data, label, grad_scale=None):
    """The head's output, softmax(``data``), as ``nd.Custom``; under
    ``autograd.record()`` its gradient is ``p - onehot(label)``, times
    ``grad_scale`` (a (1,) NDArray) when given."""
    if grad_scale is None:
        return nd.Custom(data, label, op_type="rtc_softmax")
    return nd.Custom(data, label, grad_scale, op_type="rtc_softmax",
                     scaled=True)


# -- the training harness (train_imagenet.py --benchmark 1) ---------------

SEED = 20240917
IMAGE, CLASSES = 224, 1000
LR, MOMENTUM, WD = 0.1, 0.9, 1e-4


def build_resnet50(ctx, seed=SEED, classes=CLASSES, layout="NCHW"):
    """``resnet50_v1`` with Xavier weights drawn from ``seed`` on ``ctx``
    (shapes finished by one forward of one image)."""
    mxrandom.seed(seed)
    net = vision.resnet50_v1(classes=classes, layout=layout)
    net.initialize(initializer.Xavier(), ctx=ctx)
    shape = (1, 3, IMAGE, IMAGE) if layout == "NCHW" else \
        (1, IMAGE, IMAGE, 3)
    with autograd.pause():
        net(nd.zeros(shape, ctx=ctx))
    return net


def synthetic_batch(batch, ctx, seed=SEED, classes=CLASSES, layout="NCHW"):
    """One fixed batch from ``seed``: N(0, 1) images (B, 3, 224, 224), or
    the same images as (B, 224, 224, 3) for ``layout="NHWC"``, and
    float32 class labels (B,), made on the host with numpy."""
    rs = onp.random.RandomState(seed)
    x = rs.standard_normal((batch, 3, IMAGE, IMAGE)).astype("float32")
    y = rs.randint(0, classes, batch).astype("float32")
    if layout == "NHWC":
        x = onp.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)


def make_trainer(net):
    return gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": LR, "momentum": MOMENTUM,
                          "wd": WD})


def train_step(net, trainer, x, y, events=None, outputs=None):
    """One step: record the forward and the ``rtc_softmax`` head,
    backward (the head's gradient, summed over the batch), then
    ``trainer.step(batch)``, which rescales by 1/batch. Under AMP the
    logits (bf16 from the classifier) are cast to float32 for the head,
    and with a loss scaler (``amp.init_trainer``) the head's gradient is
    multiplied by the scale ``amp.scale_loss`` hands out (on the fused
    step the device scale itself: no host read). Returns the batch's
    mean cross-entropy of the logits (an NDArray, not synchronized;
    from ``log_softmax``, so it stays finite where a probability
    underflows). ``events``, four CUDA events, are recorded around the
    forward, backward and optimizer. A list ``outputs`` receives the
    logits."""
    rec = (lambda i: events[i].record()) if events else (lambda i: None)
    scale = None
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        with amp.scale_loss(nd.ones((1,), ctx=x.context), trainer) as scale:
            pass
    rec(0)
    with autograd.record():
        logits = net(x)
        # the head's kernels take float32 or float64: half logits
        # (AMP's classifier) are cast to float32 first
        head_in = logits.astype("float32") \
            if logits.data.dtype in (torch.bfloat16, torch.float16) \
            else logits
        p = rtc_softmax(head_in, y, grad_scale=scale)
    rec(1)
    p.backward()
    rec(2)
    trainer.step(x.shape[0])
    rec(3)
    if outputs is not None:
        outputs.append(logits)
    return cross_entropy(logits, y)


def cross_entropy(logits, y):
    """Mean ``-log softmax(logits)[label]`` over the batch, unrecorded."""
    with autograd.pause():
        logp = torch.log_softmax(logits.data.detach().float(), dim=-1)
        return NDArray(-logp.gather(1, y.data.to(torch.int64)[:, None])
                       .mean())


def _kind(name):
    """The layer a device operation belongs to, from its kernel name."""
    if "rtc_softmax" in name:
        return "k4_rtc_softmax"
    if "multi_tensor_apply" in name or "foreach" in name or \
            "non_finite_check" in name:
        return "optimizer"  # the fused step's multi-tensor passes
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout_transpose"
    if "bn_" in name or "batch_norm" in name or "batchnorm" in name:
        return "batch_norm"
    if "Welford" in name:
        return "running_stats"  # the batch statistics' second pass
    low = name.lower()
    # cuDNN's algorithms: implicit GEMM, Winograd, and FFT (whose complex
    # GEMMs run in cuBLAS, "cf32")
    if any(k in low for k in ("wgrad", "dgrad", "fprop", "conv", "winograd",
                              "fft", "cf32")):
        return "convolution"
    if "gemm" in name:
        return "gemm"
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    if "copy_kernel" in name:
        return "cast_and_copy"  # dtype casts (AMP) and layout copies
    return "elementwise_and_other"


def profile_steps(step, steps, top=15):
    """Run ``step()`` ``steps`` times under ``torch.profiler`` and return
    the host wall ms per step, the device busy ms per step (the CUDA
    kernels and copies), the device's idle share, device operations per
    step, the device time by kind (``_kind``: ms, operations and share
    per step), the ``top`` heaviest operations and ``by_name``, each
    device operation's total microseconds and count."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = collections.defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.device_time if hasattr(ev, "device_time") else \
                ev.cuda_time
            by_name[ev.name][0] += dur
            by_name[ev.name][1] += 1
            busy_us += dur
    busy_ms = busy_us / 1e3 / steps
    by_kind = collections.defaultdict(lambda: [0.0, 0])
    for name, (us, cnt) in by_name.items():
        by_kind[_kind(name)][0] += us
        by_kind[_kind(name)][1] += cnt
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms)
        if wall_ms else None,
        "device_ops_per_step": sum(c for _, c in by_name.values()) / steps,
        "device_ms_per_step_by_kind": {
            kind: {"ms": us / 1e3 / steps, "per_step": cnt / steps,
                   "share": us / busy_us if busy_us else None}
            for kind, (us, cnt) in sorted(by_kind.items(),
                                          key=lambda kv: -kv[1][0])},
        "top_device_ms_per_step": {
            name: {"ms": us / 1e3 / steps, "per_step": cnt / steps}
            for name, (us, cnt) in heaviest},
        "by_name": dict(by_name)}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    from ..kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--amp", action="store_true",
                    help="train under amp.init('bfloat16') with a loss "
                    "scaler")
    ap.add_argument("--layout", default="NCHW", choices=("NCHW", "NHWC"))
    ap.add_argument("--hybridize", action="store_true",
                    help="hybridize the net: its forward and backward run "
                    "as captured CUDA graphs (the loss head stays eager)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_resnet: needs a CUDA device")
    # full float32 (no TF32) as the parity bounds assume; cuDNN picks its
    # convolution algorithms by timing them, as MXNet does by default
    # (MXNET_CUDNN_AUTOTUNE_DEFAULT=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    ctx = gpu(0)
    net = build_resnet50(ctx, layout=args.layout)
    trainer = make_trainer(net)
    if args.amp:
        amp.init("bfloat16")
        amp.init_trainer(trainer)
    if args.hybridize:
        net.hybridize()
    x, y = synthetic_batch(args.batch, ctx, layout=args.layout)
    for _ in range(2):
        train_step(net, trainer, x, y)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    losses = []
    prof = profile_steps(
        lambda: losses.append(train_step(net, trainer, x, y)), args.steps)
    loss = losses[-1]
    counts = _build.launch_counts()
    k4_us = sum(us for name, (us, _) in prof["by_name"].items()
                if "rtc_softmax" in name)
    busy_us = prof["device_busy_ms_per_step"] * 1e3 * args.steps
    wall_ms = prof["wall_ms_per_step"]
    print(json.dumps({
        "card": _card(), "model": "resnet50_v1", "batch": args.batch,
        "amp": "bfloat16" if args.amp else None, "layout": args.layout,
        "hybridize": args.hybridize,
        "cached_op": gluon.cached_op_stats(),
        "image": IMAGE, "classes": CLASSES, "steps": args.steps,
        "last_loss": float(loss.asscalar()),
        "wall_ms_per_step": wall_ms,
        "img_per_s": args.batch * 1e3 / wall_ms,
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "device_idle_share": prof["device_idle_share"],
        "device_ops_per_step": prof["device_ops_per_step"],
        "k4_launches_per_step": {k: v / args.steps
                                 for k, v in counts.items()},
        "k4_ms_per_step": k4_us / 1e3 / args.steps,
        "k4_share_of_device_time": k4_us / busy_us if busy_us else None,
        "device_ms_per_step_by_kind": prof["device_ms_per_step_by_kind"],
        "top_device_ms_per_step": prof["top_device_ms_per_step"]}))


if __name__ == "__main__":
    main()
