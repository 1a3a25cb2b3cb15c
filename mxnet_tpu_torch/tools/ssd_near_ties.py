"""Near-tied SSD300 scores: how often the card and the CPU port order them
differently.

Trains SSD300-VGG16 on the card as ``profile_ssd.train`` does (batch 32,
hybridized, one synthetic batch from ``--seed``) and, at every
``--every``-th step after ``--after``, runs detection on the card and on
the CPU port and counts, at that training point:

- ``softmax_max_abs_diff``: the card's class probabilities against the
  CPU port's softmax of the same logits;
- ``rows_differ``: detection rows whose class id (or -1) differs between
  the card and the CPU port's whole detection (its own softmax);
- ``rows_differ_on_card_probs``: the same against the CPU port's
  ``MultiBoxDetection`` fed the card's probabilities;
- ``class_ulp_ties`` / ``class_flips``: anchors above the detection
  threshold whose two best classes lie within one float32 ulp, and
  anchors whose best class the two devices pick differently;
- ``score_ulp_ties`` / ``score_flips``: pairs of neighbouring anchors in
  an image's score order (the order NMS sweeps) within one float32 ulp,
  and pairs that the CPU's probabilities order the other way.

One JSON line per training point, then a summary line. Needs one NVIDIA
GPU, no network, writes nothing:

    python3 -m mxnet_tpu_torch.tools.ssd_near_ties [--steps 40]
"""
from __future__ import annotations

import argparse
import json

import torch

DEFAULT_SEED = 20240917  # the seed of chip_smoke.py's SSD300 phases


def _ulp_tie(hi, lo):
    """``hi >= lo`` lie within one float32 ulp of each other."""
    return torch.nextafter(lo, torch.full_like(lo, float("inf"))) >= hi


def _score_pairs(card, cpu, keep):
    """(ties, flips) over neighbouring anchors of each image's order by
    the card's best score (descending, stable, as NMS sorts)."""
    ties = flips = 0
    for b in range(card.shape[0]):
        idx = torch.nonzero(keep[b])[:, 0]
        if idx.numel() < 2:
            continue
        s = card[b, idx]
        order = torch.sort(s, descending=True, stable=True).indices
        a_i, b_i = idx[order[:-1]], idx[order[1:]]
        ca, cb = card[b, a_i], card[b, b_i]
        pa, pb = cpu[b, a_i], cpu[b, b_i]
        ties += int(_ulp_tie(ca, cb).sum())
        cpu_first = (pa > pb) | ((pa == pb) & (a_i < b_i))
        flips += int((~cpu_first).sum())
    return ties, flips


def near_ties(card_probs, cpu_probs, threshold):
    """The class and score counts of one batch: ``card_probs`` and
    ``cpu_probs`` (B, C+1, N) on the card, background class 0."""
    sc, cc = card_probs[:, 1:], cpu_probs[:, 1:]
    top = torch.topk(sc, 2, dim=1).values
    best, cls = top[:, 0], torch.argmax(sc, dim=1)
    keep = best > threshold
    cpu_best, cpu_cls = cc.amax(dim=1), torch.argmax(cc, dim=1)
    score_ties, score_flips = _score_pairs(best, cpu_best, keep)
    return {"kept_anchors": int(keep.sum()),
            "class_ulp_ties": int((_ulp_tie(top[:, 0], top[:, 1])
                                   & keep).sum()),
            "class_flips": int(((cls != cpu_cls) & keep).sum()),
            "score_ulp_ties": score_ties, "score_flips": score_flips}


def run(steps=40, after=20, every=2, seed=DEFAULT_SEED, batch=32):
    """Train and count; returns the list of per-point dicts."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    from . import profile_ssd as ps

    if not torch.cuda.is_available():
        raise SystemExit("ssd_near_ties: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    ctx = mx.gpu(0)
    net = ps.build(mx, ctx, seed=seed)
    net.hybridize()
    anchor = ps.anchors(mx, ctx)
    trainer = ps.make_trainer(mx, net)
    xs, ys = ps.synthetic_batch(batch, seed=seed)
    x, y = nd.array(xs, ctx=ctx), nd.array(ys, ctx=ctx)

    def host(a):
        return nd.array(a.asnumpy(), ctx=mx.cpu())

    def rows_differ(a, b):
        return int((a.asnumpy()[..., 0] != b.asnumpy()[..., 0]).sum())

    points = []
    for step in range(1, steps + 1):
        ps.train_step(mx, net, trainer, anchor, x, y)
        if step <= after or (step - after) % every:
            continue
        with autograd.predict_mode():
            cls_preds, loc_preds = net(x)
            dets = ps.detect(mx, cls_preds, loc_preds, anchor)
            probs = nd.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
        cpu_cls = host(cls_preds)
        cpu_probs = nd.softmax(cpu_cls, axis=-1).transpose((0, 2, 1))
        whole = ps.detect(mx, cpu_cls, host(loc_preds), host(anchor))
        fed = nd.contrib.MultiBoxDetection(
            host(probs), host(loc_preds), host(anchor), **ps.DETECT)
        cpu_on_card = cpu_probs._data.to(probs._data.device)
        point = {"step": step,
                 "softmax_max_abs_diff": float(
                     (probs._data - cpu_on_card).abs().max()),
                 "rows_differ": rows_differ(dets, whole),
                 "rows_differ_on_card_probs": rows_differ(dets, fed),
                 **near_ties(probs._data, cpu_on_card,
                             ps.DETECT["threshold"])}
        print(json.dumps(point), flush=True)
        points.append(point)
    return points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--after", type=int, default=20,
                    help="first training point is after this many steps")
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    args = ap.parse_args(argv)
    from .profile_resnet import _card

    points = run(args.steps, args.after, args.every, args.seed)
    keys = [k for k in points[0] if k not in ("step",
                                              "softmax_max_abs_diff")]
    print(json.dumps({
        "card": _card(), "points": len(points),
        "softmax_max_abs_diff": max(p["softmax_max_abs_diff"]
                                    for p in points),
        **{k: [p[k] for p in points] for k in keys}}))


if __name__ == "__main__":
    main()
