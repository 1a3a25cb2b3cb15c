"""Contrib ops, third batch: quadratic, allclose, div_sqrt_dim, the
straight-through estimators, gradientmultiplier, reset_arrays,
box_encode/box_decode, hawkesll and rroi_align.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_contrib3.py``
(reference: src/operator/contrib/quadratic_op.cc, allclose_op.cc,
transformer.cc, stes_op.cc, gradient_multiplier_op.cc, reset_arrays.cc,
bounding_box.cc, hawkes_ll-inl.h, rroi_align.cc). The custom gradients
(the estimators' identity, the multiplier's scale) are
``torch.autograd.Function`` s, as the JAX ops' are ``jax.custom_vjp`` s.
``hawkesll``'s ``lax.scan`` over the events is a Python loop over T of
tensor ops under autograd, with no host read inside (its trip count is
the array's width). ``rroi_align`` is a bilinear gather over every roi at
once, as ``roi_align``.
"""
from __future__ import annotations

import math

import torch

from .ops_contrib import _consts, _div
from .registry import register


@register()
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a*x^2 + b*x + c (reference contrib/quadratic_op.cc)."""
    return a * data * data + b * data + c


@register(differentiable=False)
def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=True):
    """1.0 when every element of ``a`` is close to ``b``'s, else 0.0, as
    a (1,) float32 array (reference contrib/allclose_op.cc); read on the
    device, never on the host."""
    ok = torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)
    return ok.all().to(torch.float32).reshape(1)


@register()
def div_sqrt_dim(data):
    """data / sqrt(data.shape[-1]) (reference contrib/transformer.cc
    _contrib_div_sqrt_dim), the divisor a 0-d tensor on the device, so
    the card divides as the CPU does."""
    d = torch.full((), data.shape[-1], dtype=data.dtype, device=data.device)
    return data / torch.sqrt(d)


class _Ste(torch.autograd.Function):
    """``fwd(x)`` forward, the identity backward (reference stes_op.cc:
    the backward clones the output gradient)."""

    @staticmethod
    def forward(ctx, x, fwd):
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@register()
def round_ste(data):
    """Round half to even, with a straight-through gradient (reference
    contrib/stes_op.cc _contrib_round_ste)."""
    return _Ste.apply(data, torch.round)


@register()
def sign_ste(data):
    """Sign, with a straight-through gradient (reference
    contrib/stes_op.cc _contrib_sign_ste)."""
    return _Ste.apply(data, torch.sign)


class _GradMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scalar).to(g.dtype), None


@register()
def gradientmultiplier(data, scalar=1.0):
    """The identity forward; the backward scales the gradient by
    ``scalar`` (reference contrib/gradient_multiplier_op.cc; a
    gradient-reversal layer passes -lambda)."""
    return _GradMult.apply(data, float(scalar))


@register(differentiable=False)
def reset_arrays(*arrays, num_arrays=0):
    """Zeroed copies of every input (reference contrib/reset_arrays.cc);
    ``nd.contrib.reset_arrays`` writes them into the inputs, the
    reference's in-place contract."""
    return tuple(torch.zeros_like(a) for a in arrays)


# --- bounding-box target coding (reference bounding_box.cc) ----------------

@register(differentiable=False)
def box_encode(samples, matches, anchors, refs, means=None, stds=None):
    """The matched reference boxes as normalized center offsets of their
    anchors (reference bounding_box-inl.h box_encode). samples (B, N) in
    {+1, -1, 0}; matches (B, N) indices into refs; anchors (B, N, 4) and
    refs (B, M, 4) corner boxes. Returns (targets, masks), both
    (B, N, 4)."""
    means = _consts((0.0, 0.0, 0.0, 0.0) if means is None else means,
                    anchors).to(anchors.dtype)
    stds = _consts((0.1, 0.1, 0.2, 0.2) if stds is None else stds,
                   anchors).to(anchors.dtype)
    idx = matches.long()[..., None].expand(matches.shape + (4,))
    m = torch.gather(refs, 1, idx)
    ref_w = m[..., 2] - m[..., 0]
    ref_h = m[..., 3] - m[..., 1]
    ref_x = m[..., 0] + ref_w * 0.5
    ref_y = m[..., 1] + ref_h * 0.5
    a_w = anchors[..., 2] - anchors[..., 0]
    a_h = anchors[..., 3] - anchors[..., 1]
    a_x = anchors[..., 0] + a_w * 0.5
    a_y = anchors[..., 1] + a_h * 0.5
    t = torch.stack([(ref_x - a_x) / a_w, (ref_y - a_y) / a_h,
                     torch.log(ref_w / a_w), torch.log(ref_h / a_h)], dim=-1)
    t = (t - means) / stds
    valid = (samples > 0.5)[..., None]
    masks = valid.expand(t.shape).to(anchors.dtype)
    return torch.where(valid, t, torch.zeros((), dtype=t.dtype,
                                             device=t.device)), masks


@register(differentiable=False)
def box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="corner"):
    """Predicted center offsets back to corner boxes (reference
    bounding_box-inl.h box_decode). data (B, N, 4); anchors (1, N, 4) in
    ``format`` ('corner' or 'center')."""
    a = anchors
    if format == "corner":
        a_w = a[..., 2] - a[..., 0]
        a_h = a[..., 3] - a[..., 1]
        a_x = a[..., 0] + a_w * 0.5
        a_y = a[..., 1] + a_h * 0.5
    else:
        a_x, a_y, a_w, a_h = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    ox = data[..., 0] * std0 * a_w + a_x
    oy = data[..., 1] * std1 * a_h + a_y
    dw = data[..., 2] * std2
    dh = data[..., 3] * std3
    if clip > 0:
        dw = torch.clamp(dw, max=clip)
        dh = torch.clamp(dh, max=clip)
    ow = torch.exp(dw) * a_w * 0.5
    oh = torch.exp(dh) * a_h * 0.5
    return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)


@register(name="hawkesll")
def hawkesll(mu, alpha, beta, state, lags, marks, valid_length, max_time):
    """Log-likelihood of a marked univariate Hawkes process with
    exponential decay (reference contrib/hawkes_ll-inl.h). mu (N, K),
    alpha (K,), beta (K,), state (N, K), lags (N, T), marks (N, T) int,
    valid_length (N,), max_time (N,). Returns (ll (N,), out_state
    (N, K)).

    The JAX op's ``lax.scan`` over T, step by step: each event updates
    its mark's intensity state and adds log(lambda) less the compensator
    since that mark's last event; the remainder over [last_k, max_time]
    follows the loop. Differentiable through autograd."""
    N, T = lags.shape
    K = mu.shape[-1]
    dt = mu.dtype
    marks_i = marks.long()
    t_abs = torch.cumsum(lags.to(dt), dim=1)
    vlen = valid_length.reshape(-1).long()
    mtime = max_time.reshape(-1).to(dt)
    valid = (torch.arange(T, device=lags.device)[None, :]
             < vlen[:, None]).to(dt)
    st = state.to(dt)
    last = torch.zeros((N, K), dtype=dt, device=mu.device)
    ll = torch.zeros((N,), dtype=dt, device=mu.device)
    a_, b_ = alpha[None], beta[None]
    ks = torch.arange(K, device=mu.device)
    for j in range(T):
        tj, v = t_abs[:, j], valid[:, j]
        oh = (marks_i[:, j, None] == ks).to(dt)
        d = tj[:, None] - last
        ed = torch.exp(-b_ * d)
        lam = mu + a_ * b_ * st * ed
        comp = mu * d + a_ * st * (1.0 - ed)
        ll = ll + v * (torch.log(torch.sum(lam * oh, dim=1))
                       - torch.sum(comp * oh, dim=1))
        upd = oh * v[:, None] > 0
        st = torch.where(upd, 1.0 + st * ed, st)
        last = torch.where(upd, tj[:, None], last)
    d = mtime[:, None] - last
    ed = torch.exp(-b_ * d)
    ll = ll - torch.sum(mu * d + a_ * st * (1.0 - ed), dim=1)
    return ll, st * ed


@register()
def rroi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sampling_ratio=-1):
    """Rotated ROIAlign (reference contrib/rroi_align.cc). rois (R, 6):
    [batch_idx, cx, cy, w, h, theta in degrees]; data (N, C, H, W);
    output (R, C, ph, pw): the mean of bilinear samples on a grid rotated
    by theta about the box's center; ``sampling_ratio`` -1 takes 2 a
    bin per axis, as the JAX op."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    s = 2 if sampling_ratio <= 0 else int(sampling_ratio)
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    b = rois[:, 0].long()
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    rw = torch.clamp(rois[:, 3] * spatial_scale, min=1.0)
    rh = torch.clamp(rois[:, 4] * spatial_scale, min=1.0)
    th = rois[:, 5] * (math.pi / 180.0)
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)
    sub = _div(torch.arange(s, device=dev, dtype=dt) + 0.5, s)

    def axis(n, bin_, side):
        grid = (torch.arange(n, device=dev, dtype=dt)[:, None]
                + sub[None, :]).reshape(-1)
        return -side[:, None] / 2.0 + bin_[:, None] * grid[None, :]

    yy = axis(ph, bin_h, rh)[:, :, None]  # (R, ph*s, 1)
    xx = axis(pw, bin_w, rw)[:, None, :]  # (R, 1, pw*s)
    ones_y, ones_x = torch.ones_like(yy), torch.ones_like(xx)
    yy2, xx2 = yy * ones_x, ones_y * xx
    c_, s_ = cos_t[:, None, None], sin_t[:, None, None]
    # rotate about the center, then translate (rroi_align.cc:70-72)
    x = xx2 * c_ + yy2 * s_ + cx[:, None, None]
    y = yy2 * c_ - xx2 * s_ + cy[:, None, None]
    oob = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y = torch.clamp(y, 0.0, H - 1)
    x = torch.clamp(x, 0.0, W - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = y - y0, x - x0
    # every sample of every roi gathered from (N*H*W, C) rows at once
    flat = data.permute(0, 2, 3, 1).reshape(N * H * W, C)
    base = b[:, None, None] * (H * W)

    def gather(yi, xi):
        return flat[base + yi.long() * W + xi.long()]  # (R, ph*s, pw*s, C)

    val = (gather(y0, x0) * ((1 - ly) * (1 - lx))[..., None]
           + gather(y0, x1) * ((1 - ly) * lx)[..., None]
           + gather(y1, x0) * (ly * (1 - lx))[..., None]
           + gather(y1, x1) * (ly * lx)[..., None])
    val = torch.where(oob[..., None], torch.zeros((), dtype=dt, device=dev),
                      val)
    return val.reshape(R, ph, s, pw, s, C).mean(dim=(2, 4)).permute(
        0, 3, 1, 2)
