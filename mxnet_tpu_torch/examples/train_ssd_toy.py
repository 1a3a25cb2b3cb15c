"""Toy SSD-style detector: the MultiBox pipeline end to end (reference:
example/ssd's MultiBoxPrior → MultiBoxTarget → SmoothL1 + softmax losses
→ MultiBoxDetection at inference, shrunk to a synthetic dataset of
coloured squares). The twin of ``examples/train_ssd_toy.py`` through the
port: the same network, data, Adam Trainer and 120 steps, on the card
unless ``--cpu``; it ends with the same assertion that the final loss is
below 2.0.

  python -m mxnet_tpu_torch.examples.train_ssd_toy
  python -m mxnet_tpu_torch.examples.train_ssd_toy --cpu
"""
import argparse

IMG = 64
CLASSES = 2  # square / circle-ish blob
SIZES = [0.2, 0.4]
RATIOS = [1.0, 1.5]


def synth_batch(rng, batch):
    """Images with ONE bright square each; label = (cls, x0, y0, x1, y1):
    numpy float32, drawn from ``rng`` as the JAX example draws them."""
    import numpy as onp

    x = rng.rand(batch, 3, IMG, IMG).astype("f") * 0.1
    labels = onp.zeros((batch, 1, 5), "f")
    for i in range(batch):
        cls = rng.randint(0, CLASSES)
        w = rng.randint(12, 28)
        x0 = rng.randint(0, IMG - w)
        y0 = rng.randint(0, IMG - w)
        x[i, cls, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [cls, x0 / IMG, y0 / IMG, (x0 + w) / IMG,
                        (y0 + w) / IMG]
    return x, labels


def toy_ssd(num_anchors, **kwargs):
    """The example's ``ToySSD`` in the port (its parameter names are the
    JAX example's)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    class ToySSD(gluon.Block):
        def __init__(self, num_anchors, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                for ch in (16, 32, 64):
                    self.backbone.add(
                        nn.Conv2D(ch, 3, strides=2, padding=1,
                                  activation="relu"))
                self.cls_head = nn.Conv2D(num_anchors * (CLASSES + 1), 3,
                                          padding=1)
                self.loc_head = nn.Conv2D(num_anchors * 4, 3, padding=1)

        def forward(self, x):
            feat = self.backbone(x)  # (B, 64, 8, 8)
            cls = self.cls_head(feat)  # (B, A*(C+1), 8, 8)
            loc = self.loc_head(feat)  # (B, A*4, 8, 8)
            B = cls.shape[0]
            cls = cls.transpose((0, 2, 3, 1)).reshape(B, -1, CLASSES + 1)
            loc = loc.transpose((0, 2, 3, 1)).reshape(B, -1)
            return feat, cls, loc

    return ToySSD(num_anchors, **kwargs)


def losses(mx, net, ce, x, labels, anchors=None):
    """The example's step under ``record()``: the forward, the anchors
    (made at the first call), ``MultiBoxTarget``, softmax cross-entropy
    plus the masked smooth L1. Returns (loss, anchors)."""
    nd = mx.nd
    with mx.autograd.record():
        feat, cls_preds, loc_preds = net(x)
        if anchors is None:
            anchors = nd.contrib.MultiBoxPrior(feat, sizes=SIZES,
                                               ratios=RATIOS)
        loc_t, loc_mask, cls_t = nd.contrib.MultiBoxTarget(
            anchors, labels, cls_preds.transpose((0, 2, 1)))
        cls_loss = ce(cls_preds.reshape(-1, CLASSES + 1),
                      cls_t.reshape(-1))
        loc_loss = nd.mean(nd.smooth_l1(
            (loc_preds - loc_t) * loc_mask, scalar=1.0))
        loss = nd.mean(cls_loss) + loc_loss
    return loss, anchors


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    import numpy as onp

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    with mx.cpu() if args.cpu else mx.gpu(0):
        mx.random.seed(0)
        rng = onp.random.RandomState(0)
        net = toy_ssd(len(SIZES) + len(RATIOS) - 1)
        net.initialize(mx.init.Xavier())
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 2e-3})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        anchors = None
        first = None
        for step in range(args.steps):
            x, labels = (nd.array(a) for a in synth_batch(rng, 16))
            loss, anchors = losses(mx, net, ce, x, labels, anchors)
            loss.backward()
            trainer.step(16)
            if step % 20 == 0:
                value = float(loss.asscalar())
                first = value if first is None else first
                print(f"step {step}: loss={value:.4f}")

        # inference: decode + NMS
        xs, labels = synth_batch(rng, 4)
        feat, cls_preds, loc_preds = net(nd.array(xs))
        probs = nd.softmax(cls_preds, axis=-1).transpose((0, 2, 1))
        dets = nd.contrib.MultiBoxDetection(probs, loc_preds, anchors,
                                            threshold=0.1)
        kept = dets.asnumpy()[0]
        kept = kept[kept[:, 0] >= 0]
        print(f"detections for image 0 (gt cls {int(labels[0, 0, 0])}"
              f" box {labels[0, 0, 1:].round(2)}):")
        for d in kept[:3]:
            print(f"  cls={int(d[0])} score={d[1]:.2f} box={d[2:].round(2)}")
        final = float(loss.asscalar())
        print("done; final loss", round(final, 4))
        assert final < 2.0, "training diverged"
        return {"first_loss": first, "final_loss": final,
                "detections": kept[:3].tolist(),
                "gt": labels[0, 0].tolist()}


if __name__ == "__main__":
    main()
