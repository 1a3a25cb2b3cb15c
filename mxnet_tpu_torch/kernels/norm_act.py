"""Fused LayerNorm→activation cluster op and its CUDA kernel K3.

The PyTorch counterpart of ``mxnet_tpu/kernels/norm_act.py``.
``_fused_norm_act`` is the op the fusion pass emits for a ``layer_norm``
feeding one activation. Two implementations, chosen per cluster by the
cost model:

- ``impl="torch"`` replays the registered ``layer_norm`` and activation
  bodies (bit-identical to the unfused pair), the counterpart of
  ``"lax"``;
- ``impl="cuda"`` runs K3, ``csrc/norm_act.cu`` (the port of the TPU
  kernel ``_ln_act_kernel``, ``norm_act.py:45-87``): one pass over the
  (rows, C) view — fp32 mean and two-pass variance, normalize, gamma
  and beta, the activation, cast back — through :func:`_norm_act_cuda`,
  its wrapper. :func:`_norm_act_ref` is its plain version, the same
  arithmetic in torch.

The wrapper follows the port's rule: on a CPU tensor it runs the plain
version, on a ``meta`` tensor it returns an empty tensor of the output's
shape (so shape inference sees through a fused graph), on a CUDA tensor
it launches K3 or raises.

BatchNorm→act is not backed here: ``batch_norm`` is effectful, so the
pass only counts the match (``fallback_effectful``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray.ops_nn import SELU_ALPHA, SELU_SCALE
from ..ndarray.registry import get_op, register
from . import _build

__all__ = ["FUSABLE_ACTS", "KERNEL", "MAX_C", "act_code", "_norm_act_ref",
           "_norm_act_cuda"]

KERNEL = "norm_act"  # K3
#: the widest row K3 takes (one 256-thread block of 32 values a thread)
MAX_C = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: activation node forms a norm_act cluster may absorb: {op name: the
#: act_type values it may carry} (None: the op has no act_type)
FUSABLE_ACTS = {
    "activation": {"relu", "sigmoid", "tanh", "softrelu", "softsign"},
    "leaky_relu": {"leaky", "elu", "selu", "gelu", "rrelu"},
    "relu": {None}, "sigmoid": {None}, "tanh": {None},
    "softsign": {None},
}

# activation codes of csrc/norm_act.cu (enum Act)
_CODES = {"relu": 0, "sigmoid": 1, "tanh": 2, "softrelu": 3, "softsign": 4,
          "leaky": 5, "elu": 6, "selu": 7, "gelu": 8, "rrelu": 9}
_DEFAULT_ACT = {"activation": "relu", "leaky_relu": "leaky"}


def act_code(act_op, act_kw):
    """``(code, slope)`` of an absorbed activation node: the kernel's
    activation code and the slope it takes (leaky's and elu's ``slope``,
    rrelu's eval-mode midpoint of its bounds, else 0)."""
    kw = dict(act_kw)
    act = kw.get("act_type", _DEFAULT_ACT.get(act_op, act_op))
    if act not in _CODES:
        raise MXNetError(f"_fused_norm_act: no kernel code for {act_op} "
                         f"act_type={act!r}")
    if act in ("leaky", "elu"):
        slope = kw.get("slope", 0.25)
    elif act == "rrelu":
        slope = (kw.get("lower_bound", 0.125)
                 + kw.get("upper_bound", 0.334)) / 2.0
    else:
        slope = 0.0
    return _CODES[act], float(slope)


def _act_ref(y, code, slope):
    """The activation ``code`` on fp32 ``y``, as the kernel computes it."""
    if code == 0:
        return torch.relu(y)
    if code == 1:
        return torch.sigmoid(y)
    if code == 2:
        return torch.tanh(y)
    if code == 3:
        return torch.clamp_min(y, 0) + torch.log1p(torch.exp(-y.abs()))
    if code == 4:
        return y / (1 + y.abs())
    if code in (5, 9):
        return torch.where(y > 0, y, slope * y)
    if code == 6:
        return torch.where(y > 0, y, slope * torch.expm1(y))
    if code == 7:
        return SELU_SCALE * torch.where(y > 0, y, SELU_ALPHA * torch.expm1(y))
    if code == 8:
        return F.gelu(y)
    raise MXNetError(f"unknown activation code {code}")


def _norm_act_ref(x, gamma, beta, eps, code, slope):
    """Plain version of K3 over (rows, C): the arithmetic of the TPU
    kernel (``norm_act.py:45-55``) — fp32 mean and population variance
    over the last axis, ``(x - mean) * rsqrt(var + eps) * gamma + beta``,
    the activation, cast to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return _act_ref(y, code, slope).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load(KERNEL).mxtt_norm_act
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _norm_act_cuda(x, gamma, beta, eps, code, slope):
    """K3: LayerNorm over the last axis of the (rows, C) tensor ``x``,
    then activation ``code``; same contract as :func:`_norm_act_ref`,
    returns a fresh (rows, C) tensor of x's dtype.

    On CPU tensors this is the plain version; on meta tensors an empty
    result. On CUDA tensors it launches K3 on the current stream,
    without synchronizing, or raises: x (rows, C), gamma and beta (C,)
    must be contiguous, float32 or bfloat16 alike, on one device, with
    1 <= C <= MAX_C."""
    devs = {t.device for t in (x, gamma, beta)}
    if len(devs) != 1:
        raise MXNetError(f"_norm_act_cuda: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return _norm_act_ref(x, gamma, beta, eps, code, slope)
    if dev.type == "meta":
        return torch.empty_like(x)
    if dev.type != "cuda":
        raise MXNetError(f"_norm_act_cuda: unsupported device {dev}")
    if x.dim() != 2 or tuple(gamma.shape) != (x.shape[1],) or \
            tuple(beta.shape) != (x.shape[1],):
        raise MXNetError(
            f"_norm_act_cuda: x must be (rows, C) and gamma, beta (C,); got "
            f"{tuple(x.shape)}, {tuple(gamma.shape)}, {tuple(beta.shape)}")
    rows, C = x.shape
    if x.dtype not in _DTYPES or gamma.dtype != x.dtype or \
            beta.dtype != x.dtype:
        raise MXNetError(
            "_norm_act_cuda: the kernel takes float32 or bfloat16 x, gamma "
            f"and beta of one dtype, got {x.dtype}, {gamma.dtype}, "
            f"{beta.dtype}")
    if not 0 < C <= MAX_C:
        raise MXNetError(f"_norm_act_cuda: width {C} not in [1, {MAX_C}]")
    if not all(t.is_contiguous() for t in (x, gamma, beta)):
        raise MXNetError("_norm_act_cuda: inputs must be contiguous")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(dev):
        err = _entry()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                       out.data_ptr(), _DTYPES[x.dtype], rows, C,
                       float(eps), int(code), float(slope),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"_norm_act_cuda: kernel launch failed with CUDA "
                         f"error {err}")
    _build.count_launch(KERNEL)
    return out


@register("_fused_norm_act", namespaces=())
def _fused_norm_act(data, gamma, beta, norm_kw=(), act_op="activation",
                    act_kw=(), impl="torch"):
    """Fused LayerNorm→activation cluster emitted by the fusion pass.
    ``impl="torch"`` replays the registered ``layer_norm`` and
    activation bodies (bit-identical to the unfused pair);
    ``impl="cuda"`` runs K3 through its wrapper, which needs the norm
    over the last axis (the cost model picks it only then). K3 has no
    backward (nor has the JAX kernel), so a call whose operands need a
    gradient — a training bind's forward — replays the registered
    bodies instead, counted as ``replay_needs_grad``: K3 never runs off
    torch's graph. (Reference: src/operator/nn/layer_norm.cc +
    activation-inl.h, fused.)"""
    nkw = dict(norm_kw)
    if impl == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (data, gamma, beta)):
        from . import _count

        _count("replay_needs_grad")
        impl = "torch"
    if impl == "cuda":
        if nkw.get("axis", -1) not in (-1, data.dim() - 1) or \
                nkw.get("output_mean_var"):
            raise MXNetError("_fused_norm_act(impl='cuda') normalizes over "
                             f"the last axis only, got norm_kw={norm_kw}")
        code, slope = act_code(act_op, act_kw)
        C = data.shape[-1]
        out = _norm_act_cuda(data.reshape(-1, C).contiguous(),
                             gamma.contiguous(), beta.contiguous(),
                             float(nkw.get("eps", 1e-5)), code, slope)
        return out.reshape(data.shape)
    if impl != "torch":
        raise ValueError(f"_fused_norm_act: unknown impl {impl!r} (expected "
                         "'torch' or 'cuda')")
    out = get_op("layer_norm").fn(data, gamma, beta, **nkw)
    return get_op(act_op).fn(out, **dict(act_kw))
