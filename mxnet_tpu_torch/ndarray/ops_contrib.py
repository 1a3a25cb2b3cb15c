"""Detection ops: MultiBoxPrior/Target/Detection, box_nms, box_iou,
bipartite_matching, roi_align.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_contrib.py``
(reference: src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, bounding_box.cc, roi_align.cc). Plain functions on
tensors with static shapes and no host sync (no ``.item()``, no
``nonzero``, no shape that depends on the data), so a captured graph can
hold them as XLA holds the JAX ops. Three choices keep integer outputs
equal to the JAX package's:

- sorts are stable (``jnp.argsort`` is), so tied scores keep index
  order;
- arg-maxima take the first maximum (``torch.argmax``, as ``jnp.argmax``);
- ``box_nms`` returns rows in score order, suppressed and invalid rows
  all -1.

``box_nms``'s greedy sweep, a ``lax.fori_loop`` in the JAX op, runs the
hand-written CUDA kernel N1 on the card (``kernels/box_nms.py``); its
plain version, a Python loop over the rows, is the CPU route. The
matching loops (``bipartite_matching``, ``multibox_target``'s first
stage) run one step per column or ground-truth box, a few launches each.
``roi_align`` is differentiable through torch's autograd of its bilinear
gather, as the JAX op differentiates it with ``jax.vjp``.
"""
from __future__ import annotations

import numpy as onp
import torch

from .registry import get_op, register

_NEG_INF = float("-inf")


def _f32(v):
    """The float32 value of ``v`` as a Python float: a tensor op with it
    uses exactly the float32 constant the JAX op builds."""
    return float(onp.float32(v))


def _div(t, c):
    """``t / c`` for a Python number ``c`` as a true division, the JAX
    op's: torch on CUDA multiplies by the float reciprocal of a Python
    divisor, which can move a value across an integer (a bin edge) that
    the CPU's division does not."""
    return t / torch.full((), _f32(c), dtype=t.dtype, device=t.device)


def _consts(values, like):
    """A float32 vector of ``values`` made on ``like``'s device by fills
    (no host copy, so it can sit inside a captured graph)."""
    return torch.stack([torch.full((), _f32(v), dtype=torch.float32,
                                   device=like.device) for v in values])


# ----------------------------------------------------------------- IoU ----

def _corner_iou(a, b):
    """IoU between (..., Na, 4) and (..., Nb, 4) corner boxes →
    (..., Na, Nb)."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0) * torch.clamp(ay2 - ay1, min=0)
    area_b = torch.clamp(bx2 - bx1, min=0) * torch.clamp(by2 - by1, min=0)
    union = area_a + area_b - inter
    pos = union > 0
    # the quotient only where the union is positive, so the unused
    # branch puts no NaN into the gradient
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def _to_corner(x, fmt):
    if fmt == "corner":
        return x
    cx, cy, w, h = (x[..., i] for i in range(4))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register()
def box_iou(lhs, rhs, format="corner"):
    """Reference: src/operator/contrib/bounding_box.cc (_contrib_box_iou)."""
    return _corner_iou(_to_corner(lhs, format), _to_corner(rhs, format))


def _nms_sorted(data, valid_thresh, topk, coord_start, score_index,
                id_index, background_id, force_suppress, in_format):
    """``box_nms`` up to its sweep: the rows of (B, N, K) ``data`` in
    score order (invalid rows last, ties in index order), the valid mask
    in that order (rows past ``topk`` invalid), their corner boxes
    (B, N, 4) contiguous, the class ids the sweep compares (None:
    class-blind) and the sweep's row limit."""
    B, N, K = data.shape
    scores = data[..., score_index]
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (data[..., id_index] != background_id)
    order = torch.argsort(-scores.masked_fill(~valid, _NEG_INF), dim=-1,
                          stable=True)
    ds = torch.gather(data, 1, order[..., None].expand(B, N, K))
    vs = torch.gather(valid, 1, order)
    limit = N
    if topk > 0:
        vs = vs & (torch.arange(N, device=data.device) < topk)[None, :]
        limit = min(N, topk)
    boxes = _to_corner(ds[..., coord_start:coord_start + 4],
                       in_format).contiguous()
    ids = ds[..., id_index].contiguous() \
        if id_index >= 0 and not force_suppress else None
    return ds, vs.contiguous(), boxes, ids, limit


@register(differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Reference: src/operator/contrib/bounding_box.cc (_contrib_box_nms).
    data (..., N, K) rows [.., score, .., coords]; rows come back in score
    order, suppressed and invalid rows -1. The greedy sweep is N1 on the
    card, its plain version on the CPU (no gradient, as the
    reference)."""
    from ..kernels.box_nms import _nms_keep_cuda

    d = data
    batchless = d.dim() == 2
    if batchless:
        d = d[None]
    ds, vs, boxes, ids, limit = _nms_sorted(
        d, valid_thresh, topk, coord_start, score_index, id_index,
        background_id, force_suppress, in_format)
    keep = _nms_keep_cuda(boxes, vs, ids, overlap_thresh, limit)
    out = torch.where(keep[..., None], ds, -1.0)
    if out_format != in_format:
        coords = out[..., coord_start:coord_start + 4]
        if out_format == "corner":  # center → corner
            c = _to_corner(coords, in_format)
        else:  # corner → center
            x1, y1, x2, y2 = (coords[..., i] for i in range(4))
            c = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                             y2 - y1], dim=-1)
        out = torch.cat([out[..., :coord_start],
                         torch.where(keep[..., None], c, -1.0),
                         out[..., coord_start + 4:]], dim=-1)
    return out[0] if batchless else out


def _knock_out(s, bi, bj):
    """(B, N, M) ``s`` with row ``bi[b]`` and column ``bj[b]`` of each
    image set to -inf."""
    N, M = s.shape[1], s.shape[2]
    rows = torch.arange(N, device=s.device)[None, :, None] == bi[:, None, None]
    cols = torch.arange(M, device=s.device)[None, None, :] == bj[:, None, None]
    return s.masked_fill(rows | cols, _NEG_INF)


def _best_pair(s):
    """Row, column and value of the first maximum of each image's
    row-major flattened (N, M) matrix."""
    B, M = s.shape[0], s.shape[2]
    flat = s.reshape(B, -1)
    best = torch.argmax(flat, dim=-1)
    return best // M, best % M, torch.gather(flat, 1, best[:, None])[:, 0]


@register(differentiable=False)
def bipartite_matching(data, threshold=1e-12, is_ascend=False, topk=-1):
    """Reference: src/operator/contrib/bounding_box.cc
    (_contrib_bipartite_matching). data (B, N, M) score matrix → greedy
    1:1 matching. Returns (row_match (B,N) col index or -1,
    col_match (B,M) row index or -1)."""
    d = data
    batchless = d.dim() == 2
    if batchless:
        d = d[None]
    B, N, M = d.shape
    s = -d if is_ascend else d
    thr = -threshold if is_ascend else threshold
    n_iter = min(N, M) if topk <= 0 else min(topk, min(N, M))
    rm = torch.full((B, N), -1, dtype=torch.int64, device=d.device)
    cm = torch.full((B, M), -1, dtype=torch.int64, device=d.device)
    ar_n = torch.arange(N, device=d.device)[None]
    ar_m = torch.arange(M, device=d.device)[None]
    for _ in range(n_iter):
        bi, bj, val = _best_pair(s)
        ok = (val > thr)[:, None]
        rm = torch.where(ok & (ar_n == bi[:, None]), bj[:, None], rm)
        cm = torch.where(ok & (ar_m == bj[:, None]), bi[:, None], cm)
        s = _knock_out(s, bi, bj)
    rm, cm = rm.to(data.dtype), cm.to(data.dtype)
    return (rm[0], cm[0]) if batchless else (rm, cm)


# ----------------------------------------------------------- multibox ----

@register(differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Reference: src/operator/contrib/multibox_prior.cc. data (N,C,H,W) →
    (1, H*W*A, 4) normalized corner anchors, A = len(sizes)+len(ratios)-1:
    (size_i, ratio_0) for every size then (size_0, ratio_j) for j>0."""
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    sizes = [float(s) for s in sizes]
    ratios = [float(r) for r in ratios]
    # steps/offsets are (y, x) — reference multibox_prior param docs
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=torch.float32, device=dev)
          + _f32(offsets[0])) * _f32(step_y)
    cx = (torch.arange(W, dtype=torch.float32, device=dev)
          + _f32(offsets[1])) * _f32(step_x)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")  # (H, W)
    whs = [(s * (ratios[0] ** 0.5), s / (ratios[0] ** 0.5)) for s in sizes]
    whs += [(sizes[0] * (r ** 0.5), sizes[0] / (r ** 0.5))
            for r in ratios[1:]]
    ws = _consts([w / 2 for w, _ in whs], cy)
    hs = _consts([h / 2 for _, h in whs], cy)
    x1 = gx[..., None] - ws
    y1 = gy[..., None] - hs
    x2 = gx[..., None] + ws
    y2 = gy[..., None] + hs
    out = torch.stack([x1, y1, x2, y2], dim=-1).reshape(1, -1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


@register(differentiable=False)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Reference: src/operator/contrib/multibox_target.cc. anchor
    (1, N, 4); label (B, M, 5) rows [cls, x1, y1, x2, y2], -1-padded;
    cls_pred (B, num_cls+1, N). Returns (box_target (B, N*4),
    box_mask (B, N*4), cls_target (B, N)): bipartite match per gt, then
    IoU>threshold matching; optional hard-negative mining by background
    confidence. Batched over images (the JAX op's ``vmap``)."""
    anc = anchor.reshape(-1, 4)
    N = anc.shape[0]
    B, M = label.shape[0], label.shape[1]
    dev = anc.device
    v = [_f32(x) for x in variances]
    gt_valid = (label[..., 0] >= 0)[:, None, :]  # (B, 1, M)
    gt_boxes = label[..., 1:5]
    iou = torch.where(gt_valid, _corner_iou(anc[None], gt_boxes), 0.0)

    # stage 1: greedy bipartite — each gt claims its best anchor
    s = iou.masked_fill(~gt_valid, _NEG_INF)
    amatch = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    ar_n = torch.arange(N, device=dev)[None]
    for _ in range(M):
        bi, bj, val = _best_pair(s)
        ok = (val > 1e-12)[:, None]
        amatch = torch.where(ok & (ar_n == bi[:, None]), bj[:, None], amatch)
        s = _knock_out(s, bi, bj)
    # stage 2: remaining anchors match argmax gt if IoU > threshold
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.amax(iou, dim=2)
    amatch = torch.where((amatch < 0) & (best_iou > overlap_threshold),
                         best_gt, amatch)

    matched = amatch >= 0
    gidx = torch.clamp(amatch, 0, M - 1)
    gcls = torch.gather(label[..., 0], 1, gidx)
    cls_t = torch.where(matched, gcls + 1.0, 0.0)

    # hard negative mining: keep top-(ratio*npos) negatives by bg conf
    if negative_mining_ratio > 0:
        npos = matched.sum(dim=1, dtype=torch.int32)
        maxneg = torch.clamp(npos * _f32(negative_mining_ratio),
                             min=minimum_negative_samples).to(torch.int32)
        # background confidence after softmax over classes
        bg_conf = torch.softmax(cls_pred, dim=1)[:, 0]  # (B, N)
        neg_score = bg_conf.masked_fill(matched, float("inf"))
        # low bg confidence = hard negative → rank ascending
        rank = torch.argsort(torch.argsort(neg_score, dim=1, stable=True),
                             dim=1, stable=True)
        is_neg = ~matched & (rank < maxneg[:, None]) & \
            (1.0 - bg_conf > negative_mining_thresh)
        cls_t = torch.where(matched, cls_t,
                            torch.where(is_neg, 0.0, float(ignore_label)))

    gbox = torch.gather(gt_boxes, 1, gidx[..., None].expand(B, N, 4))
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = torch.clamp(anc[:, 2] - anc[:, 0], min=1e-8)
    ah = torch.clamp(anc[:, 3] - anc[:, 1], min=1e-8)
    gcx = (gbox[..., 0] + gbox[..., 2]) / 2
    gcy = (gbox[..., 1] + gbox[..., 3]) / 2
    gw = torch.clamp(gbox[..., 2] - gbox[..., 0], min=1e-8)
    gh = torch.clamp(gbox[..., 3] - gbox[..., 1], min=1e-8)
    bt = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                      torch.log(gw / aw) / v[2], torch.log(gh / ah) / v[3]],
                     dim=-1)
    bt = torch.where(matched[..., None], bt, 0.0).reshape(B, -1)
    bm = matched[..., None].expand(B, N, 4).to(torch.float32).reshape(B, -1)
    return bt, bm, cls_t


@register(differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Reference: src/operator/contrib/multibox_detection.cc. cls_prob
    (B, C+1, N), loc_pred (B, N*4), anchor (1, N, 4) → (B, N, 6) rows
    [class_id, score, x1, y1, x2, y2], suppressed rows -1."""
    out = _detection_rows(cls_prob, loc_pred, anchor, clip, threshold,
                          background_id, variances)
    return _nms_raw(out, nms_threshold, nms_topk, force_suppress)


def _detection_rows(cls_prob, loc_pred, anchor, clip, threshold,
                    background_id, variances):
    """``multibox_detection`` before its NMS: (B, N, 6) rows [class id,
    score, x1, y1, x2, y2] of the decoded boxes in anchor order, -1 where
    the best non-background score is not above ``threshold``."""
    B, C1, N = cls_prob.shape
    v = [_f32(x) for x in variances]
    anc = anchor.reshape(-1, 4)
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    loc = loc_pred.reshape(B, N, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw / 2
    h = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    # best non-background class per anchor
    scores = cls_prob.transpose(1, 2)  # (B, N, C+1)
    mask = torch.arange(C1, device=cls_prob.device) != background_id
    scores_nb = scores.masked_fill(~mask, _NEG_INF)
    cls = torch.argmax(scores_nb, dim=-1)
    score = torch.amax(scores_nb, dim=-1)
    # class id output excludes background slot (reference: id = argmax - 1
    # for background_id == 0)
    out_id = torch.where(cls > background_id, cls - 1, cls).to(torch.float32)
    keep = score > threshold
    out = torch.cat(
        [torch.where(keep, out_id, -1.0)[..., None],
         torch.where(keep, score, -1.0)[..., None],
         torch.where(keep[..., None], boxes, -1.0)], dim=-1)
    return out


def _nms_raw(out, nms_threshold, nms_topk, force_suppress):
    return get_op("box_nms").fn(
        out, overlap_thresh=nms_threshold, valid_thresh=0.0, topk=nms_topk,
        coord_start=2, score_index=1, id_index=0,
        force_suppress=force_suppress)


# ----------------------------------------------------------- roi_align ----

@register()
def roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False):
    """Reference: src/operator/contrib/roi_align.cc (Mask-RCNN ROIAlign).
    Average of bilinear samples on a fixed grid per bin (sample_ratio
    points per axis; -1 → 2, static). Differentiable through torch's
    autograd of the gather (the reference writes its backward by hand;
    the JAX op takes ``jax.vjp``)."""
    if position_sensitive:
        raise NotImplementedError(
            "position_sensitive=True (PSROIAlign) is not implemented")
    ph, pw = pooled_size
    s = 2 if sample_ratio <= 0 else int(sample_ratio)
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    rois = rois.to(torch.float32)
    b = rois[:, 0].to(torch.int64)
    scale = _f32(spatial_scale)
    x1 = rois[:, 1] * scale
    y1 = rois[:, 2] * scale
    x2 = rois[:, 3] * scale
    y2 = rois[:, 4] * scale
    bw = torch.clamp(x2 - x1, min=1.0) / pw
    bh = torch.clamp(y2 - y1, min=1.0) / ph
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    sy = torch.arange(s, dtype=torch.float32, device=dev)
    # sample centers: y1 + (i + (k+0.5)/s) * bh
    ys = y1[:, None, None] + (iy[:, None] + (sy[None, :] + 0.5) / s) \
        * bh[:, None, None]
    xs = x1[:, None, None] + (ix[:, None] + (sy[None, :] + 0.5) / s) \
        * bw[:, None, None]
    ys = ys.reshape(R, -1)  # (R, ph*s)
    xs = xs.reshape(R, -1)  # (R, pw*s)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None, :, None]
    wx = (xs - x0)[:, None, None, :]

    def gat(yi, xi):
        yi = torch.clamp(yi.to(torch.int64), 0, H - 1)
        xi = torch.clamp(xi.to(torch.int64), 0, W - 1)
        # (R, ph*s, pw*s, C) → (R, C, ph*s, pw*s)
        return data[b[:, None, None], :, yi[:, :, None],
                    xi[:, None, :]].permute(0, 3, 1, 2)

    v00 = gat(y0, x0)
    v01 = gat(y0, x0 + 1)
    v10 = gat(y0 + 1, x0)
    v11 = gat(y0 + 1, x0 + 1)
    val = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
           v10 * wy * (1 - wx) + v11 * wy * wx)  # (R, C, ph*s, pw*s)
    return val.reshape(R, C, ph, s, pw, s).mean(dim=(3, 5))
