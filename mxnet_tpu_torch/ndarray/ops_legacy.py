"""Legacy top-level ops: regression and SVM outputs, smooth_l1, moments,
batch_take, crop, ROI pooling, the spatial-transformer family and
correlation.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_legacy.py``
(reference: src/operator/regression_output-inl.h, svm_output-inl.h,
roi_pooling-inl.h, grid_generator-inl.h, bilinear_sampler-inl.h,
spatial_transformer-inl.h, correlation-inl.h, crop-inl.h,
nn/moments-inl.h, tensor/indexing_op.h batch_take). The output heads'
forward is the identity (the sigmoid for the logistic head); their
backward ignores the incoming head gradient's value: the regression
heads give ``(forward - label) * grad_scale / num_output`` (the sign of
``data - label`` for the MAE head), ``num_output`` the per-sample
feature count; ``svm_output`` gives the (squared) hinge loss's gradient
times ``regularization_coefficient``; the label gets a zero gradient. A
bound executor gives the regression heads the unscaled loss-head
gradient instead (``executor.py``), as the JAX executor's ``loss_fn``
does. The other ops are the JAX ops' arithmetic in torch: masked maxes
for ROI pooling, gathers for the bilinear sampler, one shifted product
per displacement for correlation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register


def _per_sample(data):
    """grad_scale / num_output scaling, num_output the per-sample feature
    count (reference regression_output-inl.h:201)."""
    return max(math.prod(data.shape[1:]), 1) if data.dim() > 1 else 1


class _HeadGradFree(torch.autograd.Function):
    """``fwd(data)`` forward; ``grad(data, label)`` * grad_scale /
    num_output backward, whatever the head gradient holds."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, fwd, grad):
        ctx.save_for_backward(data, label)
        ctx.grad_scale, ctx.grad = grad_scale, grad
        return fwd(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        gd = ctx.grad(data, label.reshape(data.shape)) * \
            (ctx.grad_scale / _per_sample(data))
        return gd, torch.zeros_like(label), None, None, None


def _identity(x):
    return x.view_as(x)


def _head(data, label, grad_scale, fwd, grad):
    if data.is_meta:
        return torch.empty_like(data)
    return _HeadGradFree.apply(data, label, float(grad_scale), fwd, grad)


@register()
def linear_regression_output(data, label, grad_scale=1.0):
    """Reference: regression_output.cc LinearRegressionOutput."""
    return _head(data, label, grad_scale, _identity, lambda d, l: d - l)


@register()
def mae_regression_output(data, label, grad_scale=1.0):
    """Reference: regression_output.cc MAERegressionOutput."""
    return _head(data, label, grad_scale, _identity,
                 lambda d, l: torch.sign(d - l))


@register()
def logistic_regression_output(data, label, grad_scale=1.0):
    """Reference: regression_output.cc LogisticRegressionOutput."""
    return _head(data, label, grad_scale, torch.sigmoid,
                 lambda d, l: torch.sigmoid(d) - l)


class _SVMOutput(torch.autograd.Function):
    """``svm_output``: the identity forward; the backward is the hinge
    loss's gradient (``use_linear``) or the squared hinge's, whatever the
    head gradient holds (the JAX op's ``_svm_b``)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.margin, ctx.reg_coef, ctx.use_linear = margin, reg_coef, \
            use_linear
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        cls = torch.arange(data.shape[1], device=data.device)
        onehot = label.to(torch.int64).unsqueeze(-1) == cls
        signed = torch.where(onehot, data, -data)
        viol = (ctx.margin - signed) > 0
        sign = torch.where(onehot, -1.0, 1.0).to(data.dtype)
        grad = sign if ctx.use_linear else \
            2.0 * (ctx.margin - signed) * sign
        grad = torch.where(viol, grad, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))
        return grad * ctx.reg_coef, torch.zeros_like(label), None, None, None


@register()
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Reference: src/operator/svm_output.cc (:class:`_SVMOutput`)."""
    if data.is_meta:
        return torch.empty_like(data)
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


@register()
def smooth_l1(data, scalar=1.0):
    """0.5 (s x)^2 where |x| < 1 / s^2, else |x| - 0.5 / s^2 (reference:
    mshadow_op.h smooth_l1_loss)."""
    s2 = float(scalar) ** 2
    ax = torch.abs(data)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * data * data, ax - 0.5 / s2)


@register()
def moments(data, axes=None, keepdims=False):
    """The mean and the population variance over ``axes`` (every axis for
    None) (reference: src/operator/nn/moments.cc)."""
    axes = tuple(range(data.dim())) if axes is None else tuple(axes)
    mean = data.mean(dim=axes, keepdim=keepdims)
    mk = data.mean(dim=axes, keepdim=True)
    return mean, ((data - mk) ** 2).mean(dim=axes, keepdim=keepdims)


@register()
def batch_take(a, indices):
    """``a[i, indices[i]]`` for every row i (reference: indexing_op.h
    BatchTake)."""
    return torch.gather(a, 1, indices.to(torch.int64).reshape(-1, 1)) \
        .reshape(-1)


@register(name="crop")
def crop_op(data, crop_like=None, offset=(0, 0), h_w=(0, 0),
            center_crop=False):
    """The last two (H, W) axes cut to ``h_w`` (or ``crop_like``'s spatial
    shape) from ``offset`` or the center (reference: src/operator/crop.cc,
    the legacy Crop)."""
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = h_w
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = offset
    return data[:, :, oy:oy + th, ox:ox + tw]


@register()
def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Each ROI of ``rois`` (R, 5) = [batch index, x1, y1, x2, y2] in image
    coordinates max-pooled into a ``pooled_size`` grid; an empty bin is 0
    (reference: src/operator/roi_pooling.cc). Two separable masked maxes,
    over columns then rows, as the JAX op computes it."""
    ph, pw = pooled_size
    _, _, H, W = data.shape
    r = rois.to(torch.float32)
    dev = data.device
    x1, y1, x2, y2 = (torch.round(r[:, i] * spatial_scale)
                      for i in range(1, 5))
    bh = torch.clamp_min(y2 - y1 + 1.0, 1.0) / ph
    bw = torch.clamp_min(x2 - x1 + 1.0, 1.0) / pw

    def mask(n_bins, size, width, start):
        i = torch.arange(n_bins, dtype=torch.float32, device=dev)
        lo = torch.floor(i * width[:, None]) + start[:, None]
        hi = torch.ceil((i + 1.0) * width[:, None]) + start[:, None]
        pos = torch.arange(size, dtype=torch.float32, device=dev)
        return (pos >= lo[..., None]) & (pos < hi[..., None])

    rmask = mask(ph, H, bh, y1)  # (R, ph, H)
    cmask = mask(pw, W, bw, x1)  # (R, pw, W)
    img = data[r[:, 0].to(torch.int64)]  # (R, C, H, W)
    neg = torch.full((), float("-inf"), dtype=data.dtype, device=dev)
    t = torch.where(cmask[:, None, None], img[:, :, :, None, :],
                    neg).amax(dim=-1)  # (R, C, H, pw)
    out = torch.where(rmask[:, None, :, :, None], t[:, :, None],
                      neg).amax(dim=3)  # (R, C, ph, pw)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _linspace11(n, dev):
    """``jnp.linspace(-1, 1, n)``'s arithmetic: -(1 - t) + t at t = i /
    (n - 1), the last point 1 itself."""
    if n == 1:
        return torch.full((1,), -1.0, device=dev)
    t = torch.arange(n - 1, dtype=torch.float32, device=dev) / (n - 1)
    return torch.cat([-1.0 * (1 - t) + 1.0 * t,
                      torch.ones(1, device=dev)])


def _identity_grid(h, w, dev):
    gy, gx = torch.meshgrid(_linspace11(h, dev), _linspace11(w, dev),
                            indexing="ij")
    return gx, gy


@register()
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid (N, 2, H, W), x then y in [-1, 1] (reference:
    src/operator/grid_generator.cc): ``affine`` applies ``data`` (N, 6),
    a row-major 2x3 matrix, to the identity grid of ``target_shape``;
    ``warp`` adds the pixel flow ``data`` (N, 2, H, W) to it."""
    if transform_type == "affine":
        h, w = target_shape
        gx, gy = _identity_grid(h, w, data.device)
        base = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
        theta = data.reshape(-1, 2, 3).to(torch.float32)
        return torch.matmul(theta, base).reshape(-1, 2, h, w)
    _, _, h, w = data.shape
    gx, gy = _identity_grid(h, w, data.device)
    fx = data[:, 0] * (2.0 / max(w - 1, 1))
    fy = data[:, 1] * (2.0 / max(h - 1, 1))
    return torch.stack([gx[None] + fx, gy[None] + fy], dim=1)


@register()
def bilinear_sampler(data, grid, cudnn_off=None):
    """``data`` (N, C, H, W) sampled bilinearly at ``grid`` (N, 2, h, w),
    coordinates in [-1, 1]; reads outside the image are 0 (reference:
    src/operator/bilinear_sampler.cc)."""
    N, C, H, W = data.shape
    gx = (grid[:, 0].to(torch.float32) + 1.0) * (W - 1) / 2.0
    gy = (grid[:, 1].to(torch.float32) + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    img = data.to(torch.float32).reshape(N, C, H * W)

    def at(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, 1, -1)
        v = torch.gather(img, 2, flat.expand(N, C, flat.shape[2]))
        v = v.reshape((N, C) + tuple(yi.shape[1:]))
        return torch.where(valid[:, None], v, torch.zeros((), device=v.device))

    out = at(y0, x0) * ((1 - wy) * (1 - wx))[:, None] \
        + at(y0, x0 + 1) * ((1 - wy) * wx)[:, None] \
        + at(y0 + 1, x0) * (wy * (1 - wx))[:, None] \
        + at(y0 + 1, x0 + 1) * (wy * wx)[:, None]
    return out.to(data.dtype)


@register()
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=None):
    """:func:`grid_generator` (affine) then :func:`bilinear_sampler`
    (reference: src/operator/spatial_transformer.cc)."""
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=tuple(target_shape))
    return bilinear_sampler(data, grid)


@register()
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation (reference: src/operator/correlation.cc): for
    each displacement on the ``stride2`` grid, ``kernel_size`` patches of
    ``data1`` against the shifted ``data2`` (product, or absolute
    difference), summed over channels and the patch and divided by
    C * K^2; output (N, D^2, oh, ow)."""
    N, C, H, W = data1.shape
    K, md, p = kernel_size, max_displacement, pad_size
    bd = md // stride2
    a = F.pad(data1.to(torch.float32), (p, p, p, p))
    Hp, Wp = H + 2 * p, W + 2 * p
    b_big = F.pad(data2.to(torch.float32), (p + md,) * 4)
    oh = max((Hp - 2 * md - (K - 1) + stride1 - 1) // stride1, 1)
    ow = max((Wp - 2 * md - (K - 1) + stride1 - 1) // stride1, 1)
    y0 = x0 = md
    norm = float(C * K * K)
    outs = []
    for dy in range(-bd, bd + 1):
        for dx in range(-bd, bd + 1):
            sy, sx = dy * stride2, dx * stride2
            shifted = b_big[:, :, md + sy:md + sy + Hp, md + sx:md + sx + Wp]
            prod = a * shifted if is_multiply else torch.abs(a - shifted)
            win = F.avg_pool2d(prod, K, 1, divisor_override=1) if K > 1 \
                else prod
            s = win.sum(dim=1)
            patch = s[:, y0:y0 + (oh - 1) * stride1 + 1:stride1,
                      x0:x0 + (ow - 1) * stride1 + 1:stride1]
            outs.append(patch / norm)
    return torch.stack(outs, dim=1).to(data1.dtype)
