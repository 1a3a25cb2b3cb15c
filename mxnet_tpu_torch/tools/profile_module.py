"""Where one symbolic training step's time goes, on the card.

The models of the symbolic training path, and a profile of its step:

- the LSTM word-LM (``word_lm_symbol``): Embedding → dropout → a fused
  ``sym.RNN`` LSTM stack (dropout between its layers) → dropout → a
  decoder tied to the embedding → ``SoftmaxOutput``, with the final
  states as ``BlockGrad`` outputs that truncated BPTT feeds back as the
  next batch's ``h0``/``c0`` (MXNet's ``example/rnn/word_lm``). Its
  "medium" configuration (``WORD_LM``) is Zaremba et al. 2014, §4.1: a
  10,000-word vocabulary (PTB's), embedding and hidden size 650, 2
  layers, dropout 0.5, BPTT 35, batch 20, weights drawn from
  U(-0.05, 0.05) (``WORD_LM_INIT``), and their optimizer: SGD at
  learning rate 1 (``WORD_LM_OPT``) on the gradient summed over the 35
  steps and averaged over the batch, its global norm clipped at 5
  (``WORD_LM_CLIP``, ``clip_global_norm``) as MXNet's
  ``example/rnn/word_lm`` clips before ``Module.update``;
- the same model in Gluon (``GluonWordLM``: ``gluon.rnn.LSTM`` over an
  ``Embedding`` whose weight the decoder shares);
- the MNIST MLP of ``examples/train_mnist_mlp.py`` (``mlp_symbol``) and
  the bucketed LSTM LM of ``examples/train_lm_bucketing.py``
  (``bucketing_sym_gen``, over ``rnn.LSTMCell.unroll``);
- synthetic data from a seed: token ids from a Markov chain over the
  vocabulary (each word has a few likely successors, and a Zipf draw
  otherwise), so that perplexity can fall; images and labels as the
  MLP example makes them. PTB and MNIST are not in the repository.

Run on a machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_module [--steps 5]

It trains the word-LM through ``Module`` for ``--steps`` profiled steps
after two warm-up steps, eagerly (bound inside ``executor.eager_binds``)
and then with the executor's captured graphs, and prints one JSON
object with, per mode: host wall ms per step, device busy ms per step (the CUDA kernels' and
copies' times), the device's idle share, device operations per step and
the device time by kind (GEMM, cuDNN's RNN kernels, softmax,
elementwise, copies, the optimizer), and the heaviest operations. It
needs no network and writes nothing.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import time

import numpy as onp
import torch

WORD_LM = dict(vocab=10000, embed=650, hidden=650, layers=2, dropout=0.5,
               bptt=35, batch=20)
WORD_LM_OPT = {"learning_rate": 1.0}
WORD_LM_CLIP = 5.0
WORD_LM_INIT = 0.05
MLP = dict(hidden=(128, 64), classes=10, features=784, batch=128)
MLP_OPT = {"learning_rate": 0.3, "momentum": 0.9}
SEED = 20240917


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# -- data ----------------------------------------------------------------


def markov_tokens(n, vocab, seed, successors=4, stay=0.8):
    """``n`` token ids from a Markov chain: with probability ``stay`` the
    next word is one of the current word's ``successors`` (fixed by the
    seed), else a Zipf-distributed word."""
    rs = onp.random.RandomState(seed)
    succ = rs.randint(0, vocab, (vocab, successors))
    zipf = onp.minimum(rs.zipf(1.3, n) - 1, vocab - 1)
    pick = rs.randint(0, successors, n)
    jump = rs.rand(n) >= stay
    out = onp.empty(n, onp.int64)
    w = int(zipf[0])
    for i in range(n):
        w = int(zipf[i]) if jump[i] else int(succ[w, pick[i]])
        out[i] = w
    return out


def bptt_batches(tokens, bptt, batch):
    """(data, label) pairs of (bptt, batch) float arrays, time-major: the
    corpus cut into ``batch`` streams, each window's labels the next
    tokens."""
    per = (len(tokens) - 1) // batch
    streams = tokens[:per * batch + 1]
    data = streams[:per * batch].reshape(batch, per).T
    label = streams[1:per * batch + 1].reshape(batch, per).T
    return [(data[i:i + bptt].astype("float32"),
             label[i:i + bptt].astype("float32"))
            for i in range(0, per - bptt + 1, bptt)]


def mlp_data(n, features=784, classes=10, seed=0):
    """The MLP example's synthetic task: uniform images, labels the
    argmax of a random linear map."""
    rs = onp.random.RandomState(seed)
    X = rs.rand(n, features).astype("float32")
    w = rs.randn(features, classes).astype("float32")
    return X, (X @ w).argmax(1).astype("float32")


def sentences(n, vocab, lo, hi, seed):
    """``n`` sentences of lengths in [lo, hi] cut from a Markov corpus."""
    rs = onp.random.RandomState(seed + 1)
    lens = rs.randint(lo, hi + 1, n)
    toks = markov_tokens(int(lens.sum()), vocab, seed)
    out, i = [], 0
    for n_ in lens:
        out.append([int(t) for t in toks[i:i + n_]])
        i += n_
    return out


# -- models ----------------------------------------------------------------


def word_lm_symbol(sym, vocab, embed, hidden, layers, dropout, **_):
    """The word-LM as one symbol group: the softmax over the vocabulary
    for each of the (T, N) positions, then the final h and c through
    ``BlockGrad``. Inputs ``data`` (T, N) token ids, ``h0``/``c0``
    (layers, N, hidden), ``softmax_label`` (T, N); parameters
    ``embed_weight`` (also the decoder's), ``lstm_parameters``,
    ``decoder_bias``."""
    if embed != hidden:
        raise ValueError("a tied decoder needs embed == hidden")
    weight = sym.Variable("embed_weight")
    x = sym.Embedding(sym.Variable("data"), weight, input_dim=vocab,
                      output_dim=embed, name="embed")
    x = sym.Dropout(x, p=dropout, name="embed_dropout")
    rnn = sym.RNN(x, sym.Variable("lstm_parameters"), sym.Variable("h0"),
                  sym.Variable("c0"), state_size=hidden, num_layers=layers,
                  mode="lstm", p=dropout, state_outputs=True, name="lstm")
    out = sym.Dropout(rnn[0], p=dropout, name="out_dropout")
    pred = sym.FullyConnected(sym.Reshape(out, shape=(-1, hidden)), weight,
                              sym.Variable("decoder_bias"),
                              num_hidden=vocab, name="decoder")
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    soft = sym.SoftmaxOutput(pred, label, name="softmax")
    return sym.Group([soft, sym.BlockGrad(rnn[1], name="h_last"),
                      sym.BlockGrad(rnn[2], name="c_last")])


WORD_LM_DATA = ("data", "h0", "c0")


def word_lm_shapes(cfg):
    T, N, L, H = cfg["bptt"], cfg["batch"], cfg["layers"], cfg["hidden"]
    return ([("data", (T, N)), ("h0", (L, N, H)), ("c0", (L, N, H))],
            [("softmax_label", (T, N))])


def word_lm_module(mx, cfg, ctx, seed=SEED, arg_params=None):
    """A bound, initialized word-LM ``Module`` of package ``mx`` (either
    package) with SGD (``WORD_LM_OPT``); ``arg_params`` (name -> numpy)
    overrides the Uniform(``WORD_LM_INIT``) draw."""
    mod = mx.mod.Module(word_lm_symbol(mx.sym, **cfg),
                        data_names=WORD_LM_DATA,
                        label_names=("softmax_label",), context=ctx)
    data, label = word_lm_shapes(cfg)
    mod.bind(data, label)
    mx.random.seed(seed)
    if arg_params is None:
        mod.init_params(mx.init.Uniform(WORD_LM_INIT))
    else:
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                    for k, v in arg_params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        WORD_LM_OPT, rescale_grad=1.0 / cfg["batch"]))
    return mod


def clip_global_norm(mx, grads, max_norm):
    """Scale ``grads`` (NDArrays of package ``mx``) in place so that
    their global norm is at most ``max_norm``, on their device with no
    wait for the host (reference: ``example/rnn/word_lm``'s
    ``CustomStatefulModule.update(max_norm)``)."""
    total = None
    for g in grads:
        s = (g * g).sum()
        total = s if total is None else total + s
    scale = 1.0 / mx.nd.maximum(mx.nd.sqrt(total) / max_norm, 1.0)
    for g in grads:
        g[:] = g * scale


def word_lm_train(mx, mod, batches, cfg, ctx, metric=None, states=None,
                  sync_each=False):
    """Train ``mod`` over ``batches`` (data, label numpy pairs), carrying
    the final states into the next batch (truncated BPTT), the gradient's
    global norm clipped at ``WORD_LM_CLIP`` after the optimizer's
    1 / batch scale; returns the
    per-step host ms (with ``sync_each``, each step waits for the card)
    and the last states."""
    L, N, H = cfg["layers"], cfg["batch"], cfg["hidden"]
    if states is None:
        states = [mx.nd.zeros((L, N, H), ctx=ctx),
                  mx.nd.zeros((L, N, H), ctx=ctx)]
    times = []
    for x, y in batches:
        t0 = time.perf_counter()
        batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())]
                                + list(states),
                                label=[mx.nd.array(y, ctx=mx.cpu())])
        mod.forward_backward(batch)
        clip_global_norm(mx, list(mod._exec.grad_dict.values()),
                         WORD_LM_CLIP * N)
        mod.update()
        if metric is not None:
            mod.update_metric(metric, batch.label)
        states = mod.get_outputs()[1:3]
        if sync_each and torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, states


def gluon_word_lm_train(mx, net, trainer, batches, cfg, ctx, states=None):
    """Train the port's Gluon word-LM ``net`` over ``batches`` as
    ``word_lm_train`` trains the Module: the cross-entropy summed over
    the batch's tokens, its gradient's global norm clipped at
    ``WORD_LM_CLIP`` after ``trainer.step``'s 1 / batch scale, the states
    detached between batches. Returns the per-step summed losses
    (NDArrays, left on the device) and the last states."""
    L, N, H = cfg["layers"], cfg["batch"], cfg["hidden"]
    h, c = states or [mx.nd.zeros((L, N, H), ctx=ctx),
                      mx.nd.zeros((L, N, H), ctx=ctx)]
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    losses = []
    for x, y in batches:
        with mx.autograd.record():
            logits, h, c = net(mx.nd.array(x, ctx=ctx), h, c)
            loss = lf(logits, mx.nd.array(y.reshape(-1), ctx=ctx)).sum()
        loss.backward()
        clip_global_norm(mx, [p.grad(ctx) for p in params],
                         WORD_LM_CLIP * N)
        trainer.step(N)
        h, c = h.detach(), c.detach()
        losses.append(loss)
    return losses, [h, c]


def mlp_symbol(sym, hidden=(128, 64), classes=10, **_):
    """784-128-64-10 with ReLU and ``SoftmaxOutput``, as
    ``examples/train_mnist_mlp.py`` builds it."""
    net = sym.Variable("data")
    for i, h in enumerate(tuple(hidden) + (classes,)):
        net = sym.FullyConnected(net, name=f"fc{i + 1}", num_hidden=h,
                                 weight=sym.Variable(f"fc{i + 1}_weight"),
                                 bias=sym.Variable(f"fc{i + 1}_bias"))
        if i < len(hidden):
            net = sym.Activation(net, act_type="relu", name=f"relu{i + 1}")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")


def bucketing_sym_gen(mx, vocab, hidden, batch):
    """``examples/train_lm_bucketing.py``'s ``sym_gen``: Embedding →
    ``rnn.LSTMCell`` unrolled over the bucket's length from zero states
    → a classifier → ``SoftmaxOutput``."""
    sym = mx.sym
    cell = mx.rnn.LSTMCell(hidden, prefix="lstm_")

    def sym_gen(seq_len):
        embed = sym.embedding(sym.Variable("data"),
                              sym.Variable("embed_weight"),
                              input_dim=vocab, output_dim=hidden,
                              name="embed")
        begin = [sym.zeros((batch, hidden)), sym.zeros((batch, hidden))]
        outputs, _ = cell.unroll(seq_len, embed, begin_state=begin,
                                 merge_outputs=True)
        pred = sym.FullyConnected(sym.reshape(outputs, shape=(-1, hidden)),
                                  num_hidden=vocab,
                                  weight=sym.Variable("cls_weight"),
                                  bias=sym.Variable("cls_bias"), name="cls")
        label = sym.reshape(sym.Variable("softmax_label"), shape=(-1,))
        return (sym.SoftmaxOutput(pred, label, name="softmax"),
                ("data",), ("softmax_label",))

    return sym_gen


def gluon_word_lm(mx):
    """The word-LM as a Gluon ``HybridBlock`` class of package ``mx``:
    ``(tokens (T, N), h, c) -> (logits (T*N, V), h, c)``; the caller
    detaches the states before the next batch (truncated BPTT, as the
    reference's Gluon word-LM does)."""
    gluon, nn = mx.gluon, mx.gluon.nn

    class GluonWordLM(gluon.HybridBlock):
        def __init__(self, vocab, embed, hidden, layers, dropout, **kw):
            super().__init__(prefix="wordlm_")
            self._hidden = hidden
            with self.name_scope():
                self.encoder = nn.Embedding(vocab, embed)
                self.drop = nn.Dropout(dropout)
                self.rnn = gluon.rnn.LSTM(hidden, num_layers=layers,
                                          dropout=dropout, input_size=embed)
                self.decoder = nn.Dense(vocab, in_units=hidden,
                                        params=self.encoder.params)

        def hybrid_forward(self, F, x, h, c):
            out, (h, c) = self.rnn(self.drop(self.encoder(x)), [h, c])
            out = self.drop(out).reshape((-1, self._hidden))
            return self.decoder(out), h, c

    return GluonWordLM


# -- profiling ---------------------------------------------------------------


def _kind(name):
    low = name.lower()
    if "rnn" in low or "lstm" in low:
        return "cudnn_rnn"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "gemm"
    if "softmax" in low:
        return "softmax"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    if "embedding" in low or "index" in low or "scatter" in low or \
            "gather" in low:
        return "embedding_and_index"
    return "elementwise_and_other"


def profile_steps(step, steps):
    """Run ``step()`` ``steps`` times under ``torch.profiler`` (the card
    synchronized before and after); returns host wall ms per step, device
    busy ms per step, the idle share, device operations per step, the
    device time by kind and the heaviest operations."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = collections.defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.device_time if hasattr(ev, "device_time") else \
                ev.cuda_time
            by_name[ev.name][0] += dur
            by_name[ev.name][1] += 1
            busy_us += dur
    busy_ms = busy_us / 1e3 / steps
    by_kind = collections.defaultdict(lambda: [0.0, 0])
    for name, (us, cnt) in by_name.items():
        by_kind[_kind(name)][0] += us
        by_kind[_kind(name)][1] += cnt
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms)
        if wall_ms else None,
        "device_ops_per_step": sum(c for _, c in by_name.values()) / steps,
        "device_ms_per_step_by_kind": {
            k: {"ms": us / 1e3 / steps, "per_step": cnt / steps}
            for k, (us, cnt) in sorted(by_kind.items(),
                                       key=lambda kv: -kv[1][0])},
        "top_device_ms_per_step": {
            name[:80]: {"ms": us / 1e3 / steps, "per_step": cnt / steps}
            for name, (us, cnt) in top}}


def bind_mode(mx, graphs):
    """The context to bind a word-LM in: captured (``graphs``) or eager
    for the executor's whole life."""
    return contextlib.nullcontext() if graphs else mx.executor.eager_binds()


def repack_ms(cfg, ctx_device, reps=10):
    """cuDNN's weight repack at ``cfg``'s widths: the device time of one
    forward and backward of the port's ``rnn`` op (views of the packed
    vector, which torch copies into cuDNN's buffer at every call) against
    ``torch.nn.LSTM`` with ``flatten_parameters()`` (its weights already
    in that buffer), the same shapes, inputs and float32 scope. Each is
    the sum of the CUDA kernels' and copies' times ``torch.profiler``
    records over ``reps`` calls, per call (host time left out), taken in
    turns (port, flat, flat, port); returns the two medians in ms."""
    from ..ndarray.ops_nn import cudnn_fp32, rnn, rnn_param_size

    T, N, H, L = cfg["bptt"], cfg["batch"], cfg["hidden"], cfg["layers"]
    E = cfg["embed"]
    g = torch.Generator(device=ctx_device).manual_seed(SEED)
    x = torch.randn(T, N, E, device=ctx_device, generator=g)
    h = torch.zeros(L, N, H, device=ctx_device)
    size = rnn_param_size(L, E, H, False, "lstm")
    w = (torch.rand(size, device=ctx_device, generator=g) - 0.5) * 0.2
    w.requires_grad_(True)
    ref = torch.nn.LSTM(E, H, L).to(ctx_device)
    ref.flatten_parameters()
    xg = x.clone().requires_grad_(True)

    def port():
        with cudnn_fp32():
            out = rnn(xg, w, h, h, state_size=H, num_layers=L,
                      mode="lstm")[0]
            torch.autograd.grad(out.sum(), [xg, w])

    def flat():
        with cudnn_fp32():
            out = ref(xg, (h, h))[0]
            torch.autograd.grad(out.sum(), [xg] + list(ref.parameters()))

    def device_ms(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(ev.device_time if hasattr(ev, "device_time") else
                   ev.cuda_time for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) \
            / 1e3 / reps

    for fn in (port, flat):
        for _ in range(3):
            fn()
    got = {port: [], flat: []}
    for fn in (port, flat, flat, port):
        got[fn].append(device_ms(fn))
    return float(onp.median(got[port])), float(onp.median(got[flat]))


def main(argv=None):
    import mxnet_tpu_torch as mx

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_module: needs a CUDA device")
    ctx = mx.gpu(0)
    cfg = WORD_LM
    toks = markov_tokens(cfg["bptt"] * cfg["batch"] * (args.steps + 3) + 1,
                         cfg["vocab"], SEED)
    batches = bptt_batches(toks, cfg["bptt"], cfg["batch"])
    report = {"card": card(), "config": cfg,
              "tokens_per_step": cfg["bptt"] * cfg["batch"]}
    for graphs in (False, True):
        with bind_mode(mx, graphs):
            mod = word_lm_module(mx, cfg, ctx)
            _, states = word_lm_train(mx, mod, batches[:2], cfg, ctx)
            it = iter(batches[2:])
            box = {"states": states}

            def step():
                _, box["states"] = word_lm_train(
                    mx, mod, [next(it)], cfg, ctx, states=box["states"])

            report["captured" if graphs else "eager"] = \
                profile_steps(step, args.steps)
    report["executor"] = mx.executor.executor_stats()
    port_ms, flat_ms = repack_ms(cfg, torch.device("cuda", 0))
    report["rnn_fwd_bwd_ms"] = {"port_views": port_ms,
                                "torch_flat_weights": flat_ms}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
