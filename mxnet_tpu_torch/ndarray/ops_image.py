"""``mx.nd.image`` ops.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_image.py``
(reference: src/operator/image/image_random.cc ``_image_*``, crop.cc
``_image_crop``, resize.cc ``_image_resize``). Layouts follow the
reference: ``to_tensor`` maps HWC to CHW, ``normalize`` works on CHW or
NCHW, the others on HWC (or NHWC) with channels last.

The random ops draw their factors on the device the image lives on,
from the device's generator in ``mx.random`` (``random.generator``), as
0-d tensors: no host read and no host copy, so a CUDA graph that
registered the generator draws anew at each replay, and ``mx.random.seed``
makes the draws repeat. Threefry (the JAX package) and Philox never
agree, so they match the JAX ops in distribution, not in values; the
deterministic helpers (``_brightness``, ``_contrast``, ``_saturation``,
``_hue``, ``_adjust``, ``_gray``) are the JAX ones' arithmetic, and the
vision transforms (``gluon/data/vision/transforms.py``) take them from
here with factors drawn on the host. Constant vectors and matrices are
made on the device by fills (:func:`_const`), never copied from the
host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from .ops_contrib import _div
from .registry import register

# ITU-R BT.601 luma (reference image_random-inl.h RGB2GrayConvert)
_GRAY = (0.299, 0.587, 0.114)
# the YIQ transform pair of the reference's hue adjustment
_TYIQ = ((0.299, 0.587, 0.114),
         (0.596, -0.274, -0.321),
         (0.211, -0.523, 0.311))
_ITYIQ = ((1.0, 0.956, 0.621),
          (1.0, -0.272, -0.647),
          (1.0, -1.107, 1.705))
# AlexNet PCA lighting basis (reference AdjustLightingParam defaults)
_EIG_VAL = (55.46, 4.794, 1.148)
_EIG_VEC = ((-0.5675, 0.7192, 0.4009),
            (-0.5808, -0.0045, -0.8140),
            (-0.5836, -0.6948, 0.4203))


def _const(values, dtype, device):
    """A tensor of the nested float tuple ``values`` made by fills on
    ``device`` (no host copy, so it can sit inside a captured graph)."""
    if isinstance(values[0], (tuple, list)):
        return torch.stack([_const(v, dtype, device) for v in values])
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def _gray(hwc):
    w = _const(_GRAY, hwc.dtype, hwc.device)
    return (hwc * w).sum(dim=-1, keepdim=True)


@register(name="image_to_tensor")
def to_tensor(data):
    """HWC (or NHWC) in [0, 255] to CHW (NCHW) float32 in [0, 1]."""
    x = _div(data.to(torch.float32), 255.0)
    return x.permute((2, 0, 1) if data.dim() == 3 else (0, 3, 1, 2))


@register(name="image_normalize")
def normalize(data, mean=0.0, std=1.0):
    """Channel-wise (x - mean) / std on CHW or NCHW input."""
    def vec(v):
        v = v if isinstance(v, (tuple, list)) else (v,)
        return _const(v, data.dtype, data.device)

    cshape = [1] * data.dim()
    cshape[0 if data.dim() == 3 else 1] = -1
    return (data - vec(mean).reshape(cshape)) / vec(std).reshape(cshape)


@register(name="image_flip_left_right")
def flip_left_right(data):
    """Flip the width axis of (..., H, W, C) images."""
    return torch.flip(data, (-2,))


@register(name="image_flip_top_bottom")
def flip_top_bottom(data):
    """Flip the height axis of (..., H, W, C) images."""
    return torch.flip(data, (-3,))


def _coin(data):
    """A fair coin as a 0-d bool tensor on ``data``'s device."""
    gen = _random.generator(data.device)
    return torch.rand((), device=data.device, generator=gen) < 0.5


@register(name="image_random_flip_left_right", differentiable=False)
def random_flip_left_right(data):
    """Flip the width axis with probability 1/2."""
    return torch.where(_coin(data), torch.flip(data, (-2,)), data)


@register(name="image_random_flip_top_bottom", differentiable=False)
def random_flip_top_bottom(data):
    """Flip the height axis with probability 1/2."""
    return torch.where(_coin(data), torch.flip(data, (-3,)), data)


def _brightness(data, alpha):
    return data * alpha


def _contrast(data, alpha):
    # blend with the image's mean luma (reference ContrastImpl)
    mean_gray = _gray(data).mean(dim=(-3, -2), keepdim=True)
    return data * alpha + mean_gray * (1.0 - alpha)


def _saturation(data, alpha):
    # blend with the per-pixel luma (reference SaturationImpl)
    return data * alpha + _gray(data) * (1.0 - alpha)


def _hue(data, alpha):
    """Rotate chroma in YIQ space by pi * alpha (reference HueImpl);
    ``alpha`` a float (the transforms) or a 0-d tensor (the random op)."""
    dt, dev = data.dtype, data.device
    if isinstance(alpha, torch.Tensor):
        a = alpha.to(dt) * math.pi
        u, w = torch.cos(a), torch.sin(a)
    else:
        u = torch.full((), math.cos(alpha * math.pi), dtype=dt, device=dev)
        w = torch.full((), math.sin(alpha * math.pi), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    rot = torch.stack([one, zero, zero, zero, u, -w, zero, w, u]).reshape(
        3, 3)
    t = _const(_ITYIQ, dt, dev) @ rot @ _const(_TYIQ, dt, dev)
    return data @ t.T


def _adjust(data, a):
    """AlexNet PCA lighting: add eigvec @ (alpha * eigval) to every pixel
    (reference AdjustLightingImpl); ``a`` three floats or a (3,)
    tensor."""
    dev = data.device
    a = a.to(torch.float32) if isinstance(a, torch.Tensor) else \
        _const(tuple(float(v) for v in a), torch.float32, dev)
    a = a * _const(_EIG_VAL, torch.float32, dev)
    offset = _const(_EIG_VEC, torch.float32, dev) @ a
    return data + offset.to(data.dtype)


def _unif(data, lo, hi):
    """A U(lo, hi) factor as a 0-d float32 tensor on ``data``'s device."""
    gen = _random.generator(data.device)
    u = torch.rand((), device=data.device, generator=gen)
    return u * (hi - lo) + lo


@register(name="image_random_brightness", differentiable=False)
def random_brightness(data, min_factor=0.0, max_factor=0.0):
    """Scale the intensity by a U(min_factor, max_factor) factor."""
    return _brightness(data, _unif(data, min_factor, max_factor))


@register(name="image_random_contrast", differentiable=False)
def random_contrast(data, min_factor=0.0, max_factor=0.0):
    """Blend with the mean luma by a U(min_factor, max_factor) factor."""
    return _contrast(data, _unif(data, min_factor, max_factor))


@register(name="image_random_saturation", differentiable=False)
def random_saturation(data, min_factor=0.0, max_factor=0.0):
    """Blend with the per-pixel luma by a U(min_factor, max_factor)
    factor."""
    return _saturation(data, _unif(data, min_factor, max_factor))


@register(name="image_random_hue", differentiable=False)
def random_hue(data, min_factor=0.0, max_factor=0.0):
    """Rotate the hue in YIQ space by a U(min_factor, max_factor)
    factor."""
    return _hue(data, _unif(data, min_factor, max_factor))


@register(name="image_random_color_jitter", differentiable=False)
def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0):
    """The four jitters in this order, each with its own draw, as the JAX
    op composes them."""
    if brightness > 0:
        data = _brightness(data, _unif(data, 1 - brightness, 1 + brightness))
    if contrast > 0:
        data = _contrast(data, _unif(data, 1 - contrast, 1 + contrast))
    if saturation > 0:
        data = _saturation(data, _unif(data, 1 - saturation, 1 + saturation))
    if hue > 0:
        data = _hue(data, _unif(data, -hue, hue))
    return data


@register(name="image_adjust_lighting")
def adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """Add PCA lighting noise with the fixed weights ``alpha`` (reference
    image_random.cc AdjustLighting)."""
    return _adjust(data, alpha)


@register(name="image_random_lighting", differentiable=False)
def random_lighting(data, alpha_std=0.05):
    """Add AlexNet-style PCA lighting noise, alpha ~ N(0, alpha_std)
    (reference image_random.cc RandomLighting)."""
    gen = _random.generator(data.device)
    a = torch.randn(3, device=data.device, generator=gen) * alpha_std
    return _adjust(data, a)


@register(name="image_crop")
def image_crop(data, x=0, y=0, width=1, height=1):
    """The crop at (x, y) of size (width, height) of HWC/NHWC images
    (reference crop.cc ``_image_crop``)."""
    hax = data.dim() - 3
    return data.narrow(hax, y, height).narrow(hax + 1, x, width)


@register(name="image_resize")
def image_resize(data, size=0, keep_ratio=False, interp=1):
    """Bilinear (``interp`` 1) or nearest (0) resize of HWC/NHWC images
    (reference resize.cc); ``size`` an int (the shorter side with
    ``keep_ratio``, else a square) or (w, h). The JAX op's
    ``jax.image.resize``: half-pixel centers, bilinear antialiased when
    it shrinks (``F.interpolate(..., antialias=True)``), nearest at
    floor((i + 0.5) * in / out) (``"nearest-exact"``); computed in
    float32 and cast back to the input's dtype (uint8 truncates)."""
    hax = data.dim() - 3
    h, w = data.shape[hax], data.shape[hax + 1]
    if isinstance(size, (tuple, list)):
        new_w, new_h = int(size[0]), int(size[1])
    elif keep_ratio:
        if h < w:
            new_h, new_w = int(size), max(1, round(int(size) * w / h))
        else:
            new_w, new_h = int(size), max(1, round(int(size) * h / w))
    else:
        new_h = new_w = int(size)
    x = data.to(torch.float32)
    nchw = (x.unsqueeze(0) if data.dim() == 3 else x).permute(0, 3, 1, 2)
    if interp:
        out = F.interpolate(nchw, size=(new_h, new_w), mode="bilinear",
                            align_corners=False, antialias=True)
    else:
        out = F.interpolate(nchw, size=(new_h, new_w), mode="nearest-exact")
    out = out.permute(0, 2, 3, 1)
    if data.dim() == 3:
        out = out[0]
    return out.to(data.dtype)
