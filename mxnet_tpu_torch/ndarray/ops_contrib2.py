"""Contrib ops, second batch: FFT, count_sketch, deformable convolution,
RPN proposals, (deformable) PSROI pooling and Mask R-CNN mask targets.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_contrib2.py``
(reference: src/operator/contrib/fft.cc, count_sketch.cc,
deformable_convolution.cc, proposal.cc, multi_proposal.cc,
psroi_pooling.cc, deformable_psroi_pooling.cc, mrcnn_mask_target.cu).
Plain tensor functions with static shapes and no host read, so a CUDA
graph can hold them:

- ``fft``/``ifft`` are ``torch.fft`` (cuFFT on the card) in the
  reference's interleaved layout, ``ifft`` unnormalized as cuFFT is;
- every bilinear sample is a gather of four taps from the flattened
  input, zero outside it (:func:`_taps`), so the deformable convolution
  is one im2col gather per tap corner over every tap and pixel at once
  and one batched ``matmul``, and its gradients to the data, the offsets
  and the weight are autograd's;
- PSROI bin sums come from a 2-D integral image (in float64), four
  gathers a bin;
- the proposals' greedy NMS keeps the JAX op's scan of ``post_n`` steps
  (argmax, suppress), over every image at once and from one IoU matrix
  computed before the loop: a few launches a step and no host read. Its
  box transform's ``exp`` runs in float64 and rounds to float32, so the
  card and the CPU give the same boxes bit for bit, and so the same kept
  indices. The top-``pre_n`` scores come from a stable descending sort
  (``lax.top_k`` keeps the lower index first among equal scores).
"""
from __future__ import annotations

import numpy as onp
import torch

from .ops_contrib import _consts, _div
from .registry import register

__all__ = []

_NEG_INF = float("-inf")


# ------------------------------------------------------------------ fft ---

@register("fft")
def fft(data, compute_size=128):
    """Real to interleaved complex FFT along the last axis: (..., d) to
    (..., 2d) as [re0, im0, re1, im1, ...] (reference fft-inl.h; cuFFT's
    C2C)."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    inter = torch.stack([out.real, out.imag], dim=-1)
    return inter.reshape(data.shape[:-1] + (2 * data.shape[-1],)).to(
        torch.float32)


@register("ifft")
def ifft(data, compute_size=128):
    """Interleaved complex to real inverse FFT, unnormalized as cuFFT's
    (ifft(fft(x)) == d * x; reference fft-inl.h)."""
    d = data.shape[-1] // 2
    pairs = data.to(torch.float32).reshape(data.shape[:-1] + (d, 2))
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(comp, dim=-1, norm="forward").real.to(
        torch.float32)


# --------------------------------------------------------- count_sketch ---

@register("count_sketch")
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count-sketch projection out[:, h[i]] += s[i] * data[:, i]
    (reference count_sketch-inl.h; compact bilinear pooling). A
    scatter-add: the sums come in another order than the JAX op's."""
    n = data.shape[0]
    hh = h.reshape(-1).long()
    vals = data * s.reshape(-1).to(data.dtype)[None, :]
    return data.new_zeros((n, int(out_dim))).index_add(1, hh, vals)


# ------------------------------------------------------- bilinear taps ---

def _taps(y, x, H, W):
    """The four bilinear taps of the points (y, x) in an H x W plane:
    [(flat index y*W + x, weight)], each weight zero where its tap lies
    outside the plane (zero padding, the JAX op's ``_bilinear_chw``)."""
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = y - y0, x - x0
    out = []
    for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                      (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yy, xx = y0 + dy, x0 + dx
        valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = torch.clamp(yy, 0, H - 1).long() * W + \
            torch.clamp(xx, 0, W - 1).long()
        out.append((idx, w * valid.to(w.dtype)))
    return out


def _bilinear_at(flat, base, y, x, H, W):
    """Bilinear samples of ``flat`` (1-D: planes of H*W, zero padded) at
    (y, x), plane offsets ``base``; all broadcast to one shape."""
    val = None
    for idx, w in _taps(y, x, H, W):
        term = flat[base + idx] * w
        val = term if val is None else val + term
    return val


# ------------------------------------------------- deformable convolution ---

def _pair(v, default):
    if v is None:
        return default
    return (v, v) if isinstance(v, int) else tuple(v)


@register("deformable_convolution")
def deformable_convolution(data, offset, weight, bias=None, kernel=None,
                           stride=None, dilate=None, pad=None,
                           num_filter=0, num_group=1,
                           num_deformable_group=1, no_bias=False,
                           workspace=1024, layout=None):
    """Deformable ConvNets v1 convolution (reference
    deformable_convolution-inl.h), NCHW. Each tap (i, j) of output pixel
    (p, q) samples the input bilinearly at (p*sh - ph + i*dh + dy,
    q*sw - pw + j*dw + dx), its learned offset (dy, dx) read from
    ``offset`` (B, ndg*kh*kw*2, Ho, Wo) per deformable group of C / ndg
    channels. The im2col of every tap and pixel is four gathers (one per
    tap corner) from (B, ndg, C/ndg, H*W); the convolution is one batched
    ``matmul`` of the (G, F/G, C/G*kh*kw) weight with it, per group."""
    B, C, H, W = data.shape
    kh, kw = _pair(kernel, None)
    sh, sw = _pair(stride, (1, 1))
    dh, dw = _pair(dilate, (1, 1))
    ph, pw = _pair(pad, (0, 0))
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    K, L = kh * kw, Ho * Wo
    ndg, G = num_deformable_group, num_group
    cpg = C // ndg
    dev, dt = data.device, data.dtype
    k = torch.arange(K, device=dev)
    tap_y = (k // kw) * dh
    tap_x = (k % kw) * dw
    base_y = torch.arange(Ho, device=dev) * sh - ph
    base_x = torch.arange(Wo, device=dev) * sw - pw
    grid_y = (base_y[None, :, None] + tap_y[:, None, None]).to(dt)
    grid_x = (base_x[None, None, :] + tap_x[:, None, None]).to(dt)
    off = offset.reshape(B, ndg, K, 2, Ho, Wo)
    y = grid_y + off[:, :, :, 0]  # (B, ndg, K, Ho, Wo)
    x = grid_x + off[:, :, :, 1]
    img = data.reshape(B, ndg, cpg, H * W)
    cols = None
    for idx, w in _taps(y, x, H, W):
        g = torch.gather(img, 3, idx.reshape(B, ndg, 1, K * L).expand(
            B, ndg, cpg, K * L))
        term = g * w.reshape(B, ndg, 1, K * L)
        cols = term if cols is None else cols + term
    # (B, ndg, cpg, K*L) is (B, C, K, L): channel-major, as the weight
    cols = cols.reshape(B, G, (C // G) * K, L)
    wmat = weight.reshape(G, num_filter // G, (C // G) * K)
    out = torch.matmul(wmat[None], cols).reshape(B, num_filter, Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# -------------------------------------------------------------- proposal ---

def _make_anchors(scales, ratios, feature_stride):
    """Base anchors at one position (reference rcnn anchor generation:
    proposal-inl.h GenerateAnchors), as numpy float32 (K, 4)."""
    base = onp.array([0, 0, feature_stride - 1, feature_stride - 1],
                     "float32")
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = onp.round(onp.sqrt(size / r))
        hs = onp.round(ws * r)
        for sc in scales:
            wss, hss = ws * sc, hs * sc
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return onp.array(anchors, "float32")


def _nms_keep(boxes, scores, thresh, max_out):
    """Greedy NMS of every image's (n, 4) boxes in ``boxes`` (B, n, 4):
    (B, max_out) indices of the kept boxes, -1 past the last. The JAX
    op's scan: each step takes the first maximum of the live scores and
    suppresses what overlaps it by IoU > ``thresh`` (the ``+1``-pixel
    box convention), the IoU matrix computed once, before the steps."""
    B, n = scores.shape
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    iw = torch.clamp(torch.minimum(x2[:, :, None], x2[:, None, :])
                     - torch.maximum(x1[:, :, None], x1[:, None, :]) + 1,
                     min=0.0)
    ih = torch.clamp(torch.minimum(y2[:, :, None], y2[:, None, :])
                     - torch.maximum(y1[:, :, None], y1[:, None, :]) + 1,
                     min=0.0)
    inter = iw * ih
    # row: the step's box; column: every box (areas[j] + areas[idx])
    sup = inter / (areas[:, None, :] + areas[:, :, None] - inter) > thresh
    del iw, ih, inter
    rows = torch.arange(B, device=scores.device)
    live = scores.clone()
    neg = torch.full((B, 1), _NEG_INF, dtype=scores.dtype,
                     device=scores.device)
    keep = []
    for _ in range(max_out):
        idx = torch.argmax(live, dim=1)
        valid = live.gather(1, idx[:, None])[:, 0] > _NEG_INF
        keep.append(torch.where(valid, idx, -1))
        live = torch.where(sup[rows, idx], _NEG_INF, live)
        live = live.scatter(1, idx[:, None], neg)
    return torch.stack(keep, dim=1)


def _proposal_parts(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                    rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                    ratios, feature_stride):
    """Every image's top-``pre_n`` boxes and scores (B, n, 4), (B, n)
    and the kept indices into them (B, post_n)."""
    dev = cls_prob.device
    anchors = _consts(_make_anchors(scales, ratios, feature_stride)
                      .reshape(-1).tolist(), cls_prob).reshape(-1, 4)
    K = anchors.shape[0]
    B, _, hf, wf = cls_prob.shape
    fg = cls_prob[:, K:].permute(0, 2, 3, 1).reshape(B, -1)
    d = bbox_pred.reshape(B, K, 4, hf, wf).permute(0, 3, 4, 1, 2).reshape(
        B, -1, 4)
    sx = (torch.arange(wf, device=dev) * feature_stride).to(torch.float32)
    sy = (torch.arange(hf, device=dev) * feature_stride).to(torch.float32)
    shift = torch.stack([sx[None, :].expand(hf, wf),
                         sy[:, None].expand(hf, wf)] * 2, dim=-1)
    anc = (anchors[None, None] + shift[:, :, None, :]).reshape(-1, 4)
    # bbox transform inv (reference rcnn bbox_pred)
    ws = anc[:, 2] - anc[:, 0] + 1
    hs = anc[:, 3] - anc[:, 1] + 1
    cx = anc[:, 0] + 0.5 * (ws - 1)
    cy = anc[:, 1] + 0.5 * (hs - 1)
    ncx = d[..., 0] * ws + cx
    ncy = d[..., 1] * hs + cy

    def exp(v):
        # float64 then one rounding: the same bits on the card and the CPU
        return torch.exp(torch.clamp(v, -10, 10).double()).to(v.dtype)

    nw = exp(d[..., 2]) * ws
    nh = exp(d[..., 3]) * hs
    boxes = torch.stack([ncx - 0.5 * (nw - 1), ncy - 0.5 * (nh - 1),
                         ncx + 0.5 * (nw - 1), ncy + 0.5 * (nh - 1)], dim=-1)
    hi_x = (im_info[:, 1] - 1)[:, None]
    hi_y = (im_info[:, 0] - 1)[:, None]
    boxes = torch.stack(
        [torch.minimum(torch.clamp(boxes[..., 0], min=0.0), hi_x),
         torch.minimum(torch.clamp(boxes[..., 1], min=0.0), hi_y),
         torch.minimum(torch.clamp(boxes[..., 2], min=0.0), hi_x),
         torch.minimum(torch.clamp(boxes[..., 3], min=0.0), hi_y)], dim=-1)
    msz = (rpn_min_size * im_info[:, 2])[:, None]
    keep_sz = ((boxes[..., 2] - boxes[..., 0] + 1) >= msz) & \
        ((boxes[..., 3] - boxes[..., 1] + 1) >= msz)
    fg = torch.where(keep_sz, fg, _NEG_INF)
    pre_n = min(int(rpn_pre_nms_top_n), fg.shape[1])
    top_scores, top_idx = torch.sort(fg, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :pre_n], top_idx[:, :pre_n]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(
        B, pre_n, 4))
    keep = _nms_keep(top_boxes, top_scores, float(threshold),
                     int(rpn_post_nms_top_n))
    return top_boxes, top_scores, keep


@register("proposal", differentiable=False)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals (reference proposal.cc): rois (B*post_n, 5) as
    [batch index, x1, y1, x2, y2], the rows past an image's last kept box
    zero; with ``output_score`` also their scores (B*post_n, 1)."""
    boxes, scores, keep = _proposal_parts(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, rpn_post_nms_top_n,
        threshold, rpn_min_size, scales, ratios, feature_stride)
    B, post_n = keep.shape
    ok = keep >= 0
    safe = torch.clamp(keep, min=0)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out_boxes = torch.where(ok[..., None], torch.gather(
        boxes, 1, safe[..., None].expand(B, post_n, 4)), zero)
    out_scores = torch.where(ok, torch.gather(scores, 1, safe), zero)
    bidx = torch.arange(B, device=boxes.device).to(boxes.dtype)
    rois = torch.cat([bidx[:, None, None].expand(B, post_n, 1), out_boxes],
                     dim=-1).reshape(B * post_n, 5)
    if output_score:
        return rois, out_scores.reshape(-1, 1)
    return rois


@register("multi_proposal", differentiable=False)
def multi_proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """The batch variant (reference multi_proposal.cc): the same math,
    one NMS per image, as ``proposal`` already runs."""
    return proposal(cls_prob, bbox_pred, im_info, **kwargs)


# -------------------------------------------------------- psroi pooling ---

def _roi_box(rois, spatial_scale, shift):
    """The batch index and the scaled (x1, y1, x2, y2) of each roi, the
    corners rounded then shifted by ``shift``, as the JAX ops do."""
    b = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - shift
    y1 = torch.round(rois[:, 2]) * spatial_scale - shift
    x2 = (torch.round(rois[:, 3]) + 1) * spatial_scale - shift
    y2 = (torch.round(rois[:, 4]) + 1) * spatial_scale - shift
    return b, x1, y1, x2, y2


def _ps_channels(D, G, gi, gj):
    """Channel (d*G + gi[i])*G + gj[j] of output (d, i, j): (D, P, P)."""
    d = torch.arange(D, device=gi.device)
    return (d[:, None, None] * G + gi[None, :, None]) * G + gj[None, None, :]


@register("psroi_pooling")
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                  pooled_size=0, group_size=0):
    """Position-sensitive ROI average pooling (reference
    psroi_pooling-inl.h): (R, output_dim, P, P). Each bin's sum is four
    gathers from a 2-D integral image of the data (zero border), every
    roi and bin at once. The integral image is summed in float64: its
    running sums grow with the map while a bin's sum is their small
    difference, which float32 (the JAX op's) leaves with an error that
    depends on the summation order; each bin's mean rounds back to the
    data's dtype."""
    P = int(pooled_size)
    G = int(group_size) or P
    D = int(output_dim)
    B, C, H, W = data.shape
    dev, dt = data.device, data.dtype
    ii = torch.nn.functional.pad(data.double(), (1, 0, 1, 0)).cumsum(
        2).cumsum(3)
    flat = ii.reshape(-1)
    b, x1, y1, x2, y2 = _roi_box(rois, spatial_scale, 0.0)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bw, bh = _div(rw, P), _div(rh, P)
    i = torch.arange(P, device=dev)

    def edges(lo, step, n):
        s = torch.clamp(torch.floor(lo[:, None] + i * step[:, None]), 0, n)
        e = torch.clamp(torch.ceil(lo[:, None] + (i + 1) * step[:, None]),
                        0, n)
        return s.long(), e.long()

    hs, he = edges(y1, bh, H)  # (R, P)
    ws, we = edges(x1, bw, W)
    g = (i * G) // P
    ch = _ps_channels(D, G, g, g)  # (D, P, P)
    plane = (b[:, None, None, None] * C + ch[None]) * ((H + 1) * (W + 1))
    hs4, he4 = hs[:, None, :, None], he[:, None, :, None]
    ws4, we4 = ws[:, None, None, :], we[:, None, None, :]

    def at(hh, ww):
        return flat[plane + hh * (W + 1) + ww]

    ssum = at(he4, we4) - at(hs4, we4) - at(he4, ws4) + at(hs4, ws4)
    cnt = torch.clamp((he4 - hs4) * (we4 - ws4), min=1)
    empty = (he4 <= hs4) | (we4 <= ws4)
    return torch.where(empty, torch.zeros((), dtype=dt, device=dev),
                       (ssum / cnt).to(dt))


@register("deformable_psroi_pooling")
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=0, group_size=0, pooled_size=0,
                             part_size=0, sample_per_part=1,
                             trans_std=0.0, no_trans=False):
    """Deformable PSROI pooling (reference
    deformable_psroi_pooling-inl.h): each bin the mean of
    ``sample_per_part``² bilinear samples, shifted by the roi's part
    offset ``trans`` (R, 2, part, part) times ``trans_std`` and the roi's
    size. Only the channel each output reads is sampled, every roi and
    bin at once."""
    P = int(pooled_size)
    G = int(group_size) or P
    PT = int(part_size) or P
    sp = int(sample_per_part)
    D = int(output_dim)
    B, C, H, W = data.shape
    dev = data.device
    R = rois.shape[0]
    b, x1, y1, x2, y2 = _roi_box(rois, spatial_scale, 0.5)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bw, bh = _div(rw, P), _div(rh, P)
    i = torch.arange(P, device=dev)
    gi = (i * G) // P
    pi = (i * PT) // P
    plane = (b[:, None, None, None] * C
             + _ps_channels(D, G, gi, gi)[None]) * (H * W)  # (R, D, P, P)
    flat = data.reshape(-1)
    use_trans = trans is not None and not no_trans
    if use_trans:
        tr = trans.reshape(R, 2, PT, PT)
        ty = tr[:, 0][:, pi[:, None], pi[None, :]] * trans_std  # (R, P, P)
        tx = tr[:, 1][:, pi[:, None], pi[None, :]] * trans_std
    out = None
    for di in range(sp):
        for dj in range(sp):
            offy = _div((di + 0.5) * bh, sp)
            offx = _div((dj + 0.5) * bw, sp)
            ys = y1[:, None] + i * bh[:, None] + offy[:, None]  # (R, P)
            xs = x1[:, None] + i * bw[:, None] + offx[:, None]
            yy = ys[:, :, None].expand(R, P, P)
            xx = xs[:, None, :].expand(R, P, P)
            if use_trans:
                yy = yy + ty * rh[:, None, None]
                xx = xx + tx * rw[:, None, None]
            samp = _bilinear_at(flat, plane, yy[:, None], xx[:, None], H, W)
            out = samp if out is None else out + samp
    return _div(out, sp * sp)


# ---------------------------------------------------- mrcnn mask target ---

@register("mrcnn_mask_target", differentiable=False)
def mrcnn_mask_target(rois, gt_masks, matches, cls_targets,
                      num_rois=0, num_classes=0, mask_size=(14, 14)):
    """Mask R-CNN training targets (reference mrcnn_mask_target.cu):
    each roi's matched ground-truth mask sampled bilinearly at
    mask_size cell centers inside the roi, and the per-class selection
    weights. rois (B, N, 4), gt_masks (B, M, Hm, Wm), matches and
    cls_targets (B, N); returns (B, N, C, MS_h, MS_w) twice."""
    if isinstance(mask_size, int):
        mask_size = (mask_size, mask_size)
    MS_h, MS_w = mask_size
    B, N = rois.shape[:2]
    M, Hm, Wm = gt_masks.shape[1:]
    dev, dt = rois.device, rois.dtype
    x1, y1, x2, y2 = (rois[..., k] for k in range(4))
    fy = _div(torch.arange(MS_h, device=dev) + 0.5, MS_h)
    fx = _div(torch.arange(MS_w, device=dev) + 0.5, MS_w)
    ys = y1[..., None] + fy * (y2 - y1)[..., None]  # (B, N, MS_h)
    xs = x1[..., None] + fx * (x2 - x1)[..., None]
    yy = ys[..., :, None].expand(B, N, MS_h, MS_w)
    xx = xs[..., None, :].expand(B, N, MS_h, MS_w)
    bidx = torch.arange(B, device=dev)[:, None]
    plane = ((bidx * M + matches.long()) * (Hm * Wm))[..., None, None]
    targets = _bilinear_at(gt_masks.reshape(-1), plane, yy, xx, Hm, Wm)
    C = int(num_classes)
    cls = (cls_targets.long()[..., None] ==
           torch.arange(C, device=dev)).to(dt)  # (B, N, C)
    mask_cls = cls[:, :, :, None, None].expand(
        B, N, C, MS_h, MS_w).contiguous()
    mask_targets = targets[:, :, None].expand(
        B, N, C, MS_h, MS_w).contiguous()
    return mask_targets, mask_cls
