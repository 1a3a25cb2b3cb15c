"""Matrix-factorization recommender (reference:
example/recommenders/demo1-MF.ipynb and example/sparse/
matrix_factorization: the two-Embedding dot-product model, trained with
the Gluon API on synthetic ratings). The twin of
``examples/train_recommender_mf.py`` through the port: ``Embedding``
layers in a hybridized block (captured CUDA graphs on the card),
``L2Loss``, an Adam Trainer.

  python -m mxnet_tpu_torch.examples.train_recommender_mf --users 200
  python -m mxnet_tpu_torch.examples.train_recommender_mf --cpu
"""
import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--users", type=int, default=200)
    p.add_argument("--items", type=int, default=120)
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--ratings", type=int, default=4000)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    import numpy as onp

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon import nn

    onp.random.seed(args.seed)
    # synthetic low-rank ground truth plus noise
    true_u = onp.random.randn(args.users, 4).astype("f")
    true_i = onp.random.randn(args.items, 4).astype("f")
    u_idx = onp.random.randint(0, args.users, args.ratings)
    i_idx = onp.random.randint(0, args.items, args.ratings)
    ratings = (true_u[u_idx] * true_i[i_idx]).sum(1) + \
        0.1 * onp.random.randn(args.ratings).astype("f")

    class MFBlock(gluon.HybridBlock):
        def __init__(self, n_users, n_items, rank):
            super().__init__()
            self.user_emb = nn.Embedding(n_users, rank)
            self.item_emb = nn.Embedding(n_items, rank)

        def hybrid_forward(self, F, users, items):
            u = self.user_emb(users)
            i = self.item_emb(items)
            return (u * i).sum(axis=1)

    with mx.cpu() if args.cpu else mx.gpu(0):
        mx.random.seed(args.seed)
        net = MFBlock(args.users, args.items, args.rank)
        net.initialize(mx.init.Normal(0.1))
        net.hybridize()
        loss_fn = gluon.loss.L2Loss()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.02})

        n = args.ratings
        t0 = time.perf_counter()
        first = last = None
        for epoch in range(args.epochs):
            perm = onp.random.permutation(n)
            total = 0.0
            for s in range(0, n - args.batch + 1, args.batch):
                sel = perm[s:s + args.batch]
                bu = nd.array(u_idx[sel].astype("f"))
                bi = nd.array(i_idx[sel].astype("f"))
                br = nd.array(ratings[sel])
                with autograd.record():
                    pred = net(bu, bi)
                    l = loss_fn(pred, br).mean()
                l.backward()
                trainer.step(1)
                total += float(l.asscalar())
            mse = 2 * total / max(1, (n // args.batch))  # L2Loss = MSE / 2
            if first is None:
                first = mse
            last = mse
        dt = time.perf_counter() - t0
    print(f"MF {args.users}x{args.items} rank={args.rank}: train MSE "
          f"{first:.4f} -> {last:.4f} in {dt:.1f}s")
    assert last < first * 0.25, "matrix factorization did not converge"
    return {"first_mse": first, "last_mse": last, "seconds": dt}


if __name__ == "__main__":
    main()
