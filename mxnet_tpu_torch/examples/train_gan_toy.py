"""Toy GAN: generator against discriminator on a 2-D Gaussian ring
(reference: example/gluon/dcgan.py's training pattern: two Trainers,
detached generator samples for the discriminator's step, adversarial
losses, at smoke scale). The twin of ``examples/train_gan_toy.py``
through the port: both networks hybridized (captured CUDA graphs on the
card), ``SigmoidBinaryCrossEntropyLoss``, two Adam Trainers.

  python -m mxnet_tpu_torch.examples.train_gan_toy --steps 200
  python -m mxnet_tpu_torch.examples.train_gan_toy --cpu
"""
import argparse


def real_batch(rng, n):
    import numpy as onp

    theta = rng.rand(n) * 2 * onp.pi
    pts = onp.stack([2.0 * onp.cos(theta), 2.0 * onp.sin(theta)], 1)
    return (pts + rng.randn(n, 2) * 0.05).astype("f")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--latent", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    import numpy as onp

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    with mx.cpu() if args.cpu else mx.gpu(0):
        mx.random.seed(0)
        G = gluon.nn.HybridSequential()
        G.add(gluon.nn.Dense(32, activation="relu"),
              gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(2))
        D = gluon.nn.HybridSequential()
        D.add(gluon.nn.Dense(32, activation="relu"),
              gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(1))
        for net in (G, D):
            net.initialize(mx.init.Xavier())
            net.hybridize()
        loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        gt = gluon.Trainer(G.collect_params(), "adam",
                           {"learning_rate": 2e-3, "beta1": 0.5})
        dt = gluon.Trainer(D.collect_params(), "adam",
                           {"learning_rate": 2e-3, "beta1": 0.5})
        rng = onp.random.RandomState(0)
        ones = nd.ones((args.batch,))
        zeros = nd.zeros((args.batch,))
        dl = gl = None
        for step in range(args.steps):
            z = nd.array(rng.randn(args.batch, args.latent).astype("f"))
            real = nd.array(real_batch(rng, args.batch))
            # D step: real -> 1, detached fake -> 0
            with autograd.record():
                fake = G(z).detach()
                dl = (loss_fn(D(real), ones) + loss_fn(D(fake), zeros)).mean()
            dl.backward()
            dt.step(args.batch)
            # G step: fool D
            with autograd.record():
                gl = loss_fn(D(G(z)), ones).mean()
            gl.backward()
            gt.step(args.batch)
            if step % 50 == 0:
                print(f"step {step:4d}  d_loss={float(dl.asscalar()):.3f}  "
                      f"g_loss={float(gl.asscalar()):.3f}")
        # generated points should land near the radius-2 ring
        z = nd.array(rng.randn(512, args.latent).astype("f"))
        pts = G(z).asnumpy()
        radii = onp.sqrt((pts ** 2).sum(1))
        dtxt = f"{float(dl.asscalar()):.3f}" if dl is not None else "n/a"
        print(f"final: mean radius {radii.mean():.3f} (target 2.0), "
              f"d_loss={dtxt}")
        return {"mean_radius": float(radii.mean()),
                "d_loss": None if dl is None else float(dl.asscalar()),
                "g_loss": None if gl is None else float(gl.asscalar())}


if __name__ == "__main__":
    main()
