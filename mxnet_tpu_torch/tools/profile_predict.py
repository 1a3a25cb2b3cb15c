"""Where one served predict's time goes, on the card, for an exported
wav2vec2 CTC graph.

The graph is wav2vec2-large-lv60 (``facebook/wav2vec2-large-960h-lv60-
self``, ``config.json``: ``feat_extract_norm="layer"``, seven conv layers
of 512 channels with kernels (10, 3, 3, 3, 3, 2, 2) and strides (5, 2,
2, 2, 2, 2, 2), hidden 1024, 24 layers, 16 heads, FFN 4096, a 128-tap
positional conv in 16 groups, stable (pre-) layer norm, a 32-way CTC
head), written as MXNet symbols by :func:`wav2vec2_symbol` in the
channel-last layout, where each feature-encoder layer is
``convolution(NWC)`` → ``layer_norm(axis=-1)`` → ``leaky_relu(gelu)``
and each attention is ``batch_dot`` → scale → ``softmax`` →
``batch_dot``: the patterns the fusion pass lowers onto the kernels K3
and K1. Weight norm is folded into one weight, dropout is off (eval),
and the weights are drawn from a seed.

:func:`wav2vec2_symbol` takes the ``sym`` namespace as an argument, so a
test can build the same graph with the JAX package's ``sym``;
:func:`wav2vec2_params` draws the weights with numpy and
:func:`export_wav2vec2` writes ``{prefix}-symbol.json`` and
``{prefix}-0000.params`` with the given package's ``nd.save``.

Run on a machine with one NVIDIA GPU:

    MXNET_GRAPH_OPT=1 python3 -m mxnet_tpu_torch.tools.profile_predict \\
        [--batch 8] [--seconds 10] [--layers 24]

It exports the graph to a temporary directory, serves it through
``InferenceSession.load``, and runs ``--repeats`` predicts of
``--batch`` clips under ``torch.profiler``. It prints one JSON object:
host wall ms per predict, and each predict's; the caching allocator's
device allocations, frees and retries during the timed predicts; device
busy ms (the union of the kernels' intervals on the device timeline, so
overlapping kernels count once)
beside the plain sum of kernel times; the device's idle share, its
longest idle gaps with the host ops running then, the host's CUDA API
calls by time and Python's garbage-collector pauses; K3 and
K1 launches and device ms per predict; peak device memory of the
predicts and the weights' share of it; the heaviest kernels; and, from
one more predict evaluated node by node, where the memory peak falls
and the nodes whose transient memory (cuDNN workspace, layout copies)
is largest. It
needs no network and writes nothing outside its temporary directory
unless ``--trace PATH`` is given.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import tempfile
import time

import numpy as onp

#: ``facebook/wav2vec2-large-960h-lv60-self`` (wav2vec2-large-lv60 CTC)
WAV2VEC2_LARGE_LV60 = dict(
    conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    conv_stride=(5, 2, 2, 2, 2, 2, 2), hidden_size=1024,
    num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
    vocab_size=32, layer_norm_eps=1e-5)
SAMPLE_RATE = 16000


def frames(cfg, samples):
    """The feature encoder's output lengths for ``samples`` input
    samples, one per conv layer."""
    out = []
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        samples = (samples - k) // s + 1
        out.append(samples)
    return out


def wav2vec2_symbol(sym, cfg):
    """The wav2vec2 CTC forward as a symbol graph over ``sym`` (either
    package's): input ``data`` (B, samples, 1), output logits (B, T,
    vocab). Every node and variable is named, so the graph and its JSON
    are the same whichever package builds them."""
    eps = cfg["layer_norm_eps"]
    H = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    D = H // heads

    def ln(x, name):
        return sym.layer_norm(x, sym.var(f"{name}_gamma"),
                              sym.var(f"{name}_beta"), axis=-1, eps=eps,
                              name=name)

    def fc(x, units, name):
        return sym.fully_connected(x, sym.var(f"{name}_weight"),
                                   sym.var(f"{name}_bias"), num_hidden=units,
                                   flatten=False, name=name)

    def gelu(x, name):
        return sym.leaky_relu(x, act_type="gelu", name=name)

    x = sym.var("data")
    for i, (c, s) in enumerate(zip(cfg["conv_dim"], cfg["conv_stride"])):
        # no ``kernel=`` attribute: the weight's shape gives it, and a
        # one-element tuple does not survive the JSON round trip
        x = sym.convolution(x, sym.var(f"fe{i}_conv_weight"),
                            sym.var(f"fe{i}_conv_bias"), stride=s,
                            num_filter=c, layout="NWC", name=f"fe{i}_conv")
        x = gelu(ln(x, f"fe{i}_ln"), f"fe{i}_gelu")
    x = fc(ln(x, "fp_ln"), H, "fp_fc")
    K = cfg["num_conv_pos_embeddings"]
    pos = sym.convolution(x, sym.var("pos_conv_weight"),
                          sym.var("pos_conv_bias"), pad=K // 2, num_filter=H,
                          num_group=cfg["num_conv_pos_embedding_groups"],
                          layout="NWC", name="pos_conv")
    if K % 2 == 0:  # the "same" padding leaves one frame too many
        pos = sym.slice_axis(pos, axis=1, begin=0, end=-1, name="pos_trim")
    x = sym.broadcast_add(x, gelu(pos, "pos_gelu"), name="pos_add")
    for layer in range(cfg["num_hidden_layers"]):
        p = f"enc{layer}"
        h = ln(x, f"{p}_ln1")

        def split(t, nm):  # (B, T, H) -> (B * heads, T, D)
            t = sym.reshape(t, shape=(0, 0, heads, D), name=f"{p}_{nm}_split")
            t = sym.transpose(t, axes=(0, 2, 1, 3), name=f"{p}_{nm}_heads")
            return sym.reshape(t, shape=(-3, -2), name=f"{p}_{nm}_merge")

        q, k, v = (split(fc(h, H, f"{p}_{nm}"), nm) for nm in ("q", "k", "v"))
        s = sym.batch_dot(q, k, transpose_b=True, name=f"{p}_score")
        s = sym.broadcast_mul_scalar(s, scalar=D ** -0.5, name=f"{p}_scale")
        o = sym.batch_dot(sym.softmax(s, axis=-1, name=f"{p}_softmax"), v,
                          name=f"{p}_context")
        o = sym.reshape(o, shape=(-4, -1, heads, -2), name=f"{p}_unmerge")
        o = sym.transpose(o, axes=(0, 2, 1, 3), name=f"{p}_unheads")
        o = sym.reshape(o, shape=(0, 0, -3), name=f"{p}_concat")
        x = sym.broadcast_add(x, fc(o, H, f"{p}_out"), name=f"{p}_res1")
        h = fc(gelu(fc(ln(x, f"{p}_ln2"), cfg["intermediate_size"],
                       f"{p}_ffn1"), f"{p}_ffn_gelu"), H, f"{p}_ffn2")
        x = sym.broadcast_add(x, h, name=f"{p}_res2")
    return fc(ln(x, "enc_ln"), cfg["vocab_size"], "ctc_head")


def wav2vec2_params(cfg, seed):
    """``{variable name: float32 array}`` for :func:`wav2vec2_symbol`,
    drawn from ``seed``: convs He-normal (the positional conv with the
    reference's std 2/sqrt(k*C)), projections N(0, 0.02), biases and
    norm shifts small, norm scales near one."""
    rng = onp.random.default_rng(seed)
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    out = {}

    def put(name, shape, std, mean=0.0):
        a = rng.standard_normal(shape, dtype=onp.float32)
        out[name] = a * onp.float32(std) + onp.float32(mean)

    def ln(name, c):
        put(f"{name}_gamma", (c,), 0.1, 1.0)
        put(f"{name}_beta", (c,), 0.1)

    def fc(name, units, fan_in):
        put(f"{name}_weight", (units, fan_in), 0.02)
        put(f"{name}_bias", (units,), 0.02)

    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        put(f"fe{i}_conv_weight", (c, k, c_in), (2.0 / (k * c_in)) ** 0.5)
        put(f"fe{i}_conv_bias", (c,), 0.02)
        ln(f"fe{i}_ln", c)
        c_in = c
    ln("fp_ln", c_in)
    fc("fp_fc", H, c_in)
    K, G = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    put("pos_conv_weight", (H, K, H // G), 2.0 / (K * H) ** 0.5)
    put("pos_conv_bias", (H,), 0.02)
    for layer in range(cfg["num_hidden_layers"]):
        p = f"enc{layer}"
        ln(f"{p}_ln1", H)
        for nm in ("q", "k", "v", "out"):
            fc(f"{p}_{nm}", H, H)
        ln(f"{p}_ln2", H)
        fc(f"{p}_ffn1", I, H)
        fc(f"{p}_ffn2", H, I)
    ln("enc_ln", H)
    fc("ctc_head", cfg["vocab_size"], H)
    return out


def export_wav2vec2(prefix, sym, nd, cfg, seed):
    """Write ``{prefix}-symbol.json`` and ``{prefix}-0000.params`` (keys
    ``arg:<name>``) with the package whose ``sym`` and ``nd`` are given;
    returns the parameter count."""
    out = wav2vec2_symbol(sym, cfg)
    out.save(f"{prefix}-symbol.json")
    params = wav2vec2_params(cfg, seed)
    nd.save(f"{prefix}-0000.params",
            {f"arg:{k}": v for k, v in params.items()})
    return sum(a.size for a in params.values())


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


class _MemoryWatch(dict):
    """An evaluation cache (``Symbol._evaluate``) that records, as each
    op's value lands, the peak device memory while the op ran and the
    allocation just after it (its inputs are still held then: the
    evaluator drops dead values only after recording the new one)."""

    def __init__(self, torch, names):
        super().__init__()
        self._cuda = torch.cuda
        self._names = names
        self.rows = []
        self._cuda.reset_peak_memory_stats()

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if isinstance(key, tuple) and key[0] is not None:
            peak = self._cuda.max_memory_allocated()
            after = self._cuda.memory_allocated()
            self.rows.append({"node": self._names.get(key, key[0]),
                              "op": key[0], "peak_gb": peak / 1e9,
                              "after_gb": after / 1e9,
                              "transient_gb": (peak - after) / 1e9})
            self._cuda.reset_peak_memory_stats()


def memory_by_node(block, data, torch):
    """One forward of ``block`` (a ``SymbolBlock``) on the NDArray
    ``data``, node by node: the node where the peak falls, and the five
    nodes with the most transient memory (the peak while the op ran
    minus what is allocated once its value lands: temporaries and
    workspace, not its inputs or its output)."""
    feed = block._feed([data])
    graph = block._optimized_for(feed)
    names = {n._eval_key(): n._name for n in graph._walk()}
    torch.cuda.synchronize()
    watch = _MemoryWatch(torch, names)
    graph._evaluate(feed, watch)
    torch.cuda.synchronize()
    return {"peak": max(watch.rows, key=lambda r: r["peak_gb"]),
            "top_transient": sorted(watch.rows,
                                    key=lambda r: -r["transient_gb"])[:5],
            "nodes": len(watch.rows)}


def main(argv=None):
    import torch

    from .. import gpu, nd, serving, symbol as sym
    from ..kernels import _build
    from ..kernels.flash_attention import FLASH_KERNEL
    from ..kernels.norm_act import KERNEL as NORM_ACT_KERNEL

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8,
                    help="clips per predict (default 8)")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="clip length in seconds at 16 kHz (default 10)")
    ap.add_argument("--layers", type=int, default=24,
                    help="encoder depth (default 24, the published one)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=20240917)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA device")
    if int(os.environ.get("MXNET_GRAPH_OPT", "0") or 0) < 1:
        raise SystemExit("profile_predict: set MXNET_GRAPH_OPT=1 (the "
                         "fusion pass lowers the graph onto K3 and K1)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(WAV2VEC2_LARGE_LV60, num_hidden_layers=args.layers)
    samples = int(args.seconds * SAMPLE_RATE)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "wav2vec2")
        n_params = export_wav2vec2(prefix, sym, nd, cfg, args.seed)
        sess = serving.InferenceSession.load(
            prefix, input_shapes=[(1, samples, 1)], buckets=[args.batch],
            ctx=gpu(0))
    clips = onp.random.default_rng(args.seed).standard_normal(
        (args.batch, samples, 1), dtype=onp.float32)
    sess.predict(clips)
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    stats0 = torch.cuda.memory_stats()
    gc_pauses = []  # (generation, ms) of each collection while timed

    def gc_watch(phase, info):
        if phase == "start":
            gc_watch.t0 = time.perf_counter()
        else:
            gc_pauses.append((info["generation"],
                              (time.perf_counter() - gc_watch.t0) * 1e3))

    gc.callbacks.append(gc_watch)
    each_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            sess.predict(clips)  # returns after the device is done
            each_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sum(each_ms) / args.repeats
    gc.callbacks.remove(gc_watch)
    stats1 = torch.cuda.memory_stats()
    gc_runs = {f"gen{g}": {"runs": sum(1 for h, _ in gc_pauses if h == g),
                           "ms": sum(ms for h, ms in gc_pauses if h == g),
                           "max_ms": max([ms for h, ms in gc_pauses
                                          if h == g], default=0.0)}
               for g in range(3)}
    # the caching allocator's device calls and flushes during the timed
    # predicts: 0 once its pool is warm
    allocator = {k: stats1.get(k, 0) - stats0.get(k, 0) for k in (
        "segment.all.allocated", "segment.all.freed", "num_alloc_retries",
        "num_sync_all_streams", "num_device_alloc", "num_device_free")}
    if args.trace:
        prof.export_chrome_trace(args.trace)
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    memory = memory_by_node(sess._block, nd.array(clips, ctx=gpu(0)), torch)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    host_calls = collections.defaultdict(lambda: [0.0, 0])
    sum_us, spans, host_ops = 0.0, [], []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.device_time if hasattr(ev, "device_time") else \
                ev.cuda_time
            by_name[ev.name][0] += dur
            by_name[ev.name][1] += 1
            sum_us += dur
            spans.append((ev.time_range.start, ev.time_range.end, ev.name))
        elif ev.name.startswith("cu"):  # the host's CUDA API calls
            host_calls[ev.name][0] += ev.time_range.elapsed_us()
            host_calls[ev.name][1] += 1
        else:
            host_ops.append((ev.time_range.start, ev.time_range.end,
                             ev.name))

    def host_ops_at(t):
        """The host ops running at time ``t``, outermost first."""
        return [n for s0, e0, n in sorted(
            host_ops, key=lambda o: o[0] - o[1]) if s0 <= t <= e0][:4]
    busy_us, reach, prev, gaps = 0.0, None, None, []
    for start, end, name in sorted(spans):  # union of the device intervals
        if reach is not None and start > reach:
            gaps.append((start - reach, prev, name, (start + reach) / 2))
        if reach is None or end > reach:
            busy_us += end - max(start, reach if reach is not None else start)
            reach, prev = end, name
    per = args.repeats

    def kernel_ms(tag):
        return sum(us for name, (us, _) in by_name.items()
                   if tag in name) / 1e3 / per

    busy_ms = busy_us / 1e3 / per
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "card": _card(), "config": cfg, "parameters": int(n_params),
        "batch": args.batch, "samples": samples,
        "frames": frames(cfg, samples), "repeats": per,
        "wall_ms_per_predict": wall_ms, "wall_ms_each": each_ms,
        "allocator_calls_in_timed_predicts": allocator,
        "device_busy_ms_per_predict": busy_ms,
        "kernel_ms_sum_per_predict": sum_us / 1e3 / per,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "peak_memory_gb": peak_gb, "weights_and_session_gb": weights_gb,
        "memory_by_node": memory,
        "device_ops_per_predict": sum(c for _, c in by_name.values()) / per,
        "k3_launches_per_predict": counts.get(NORM_ACT_KERNEL, 0) / per,
        "k3_ms_per_predict": kernel_ms("norm_act_kernel"),
        "k1_launches_per_predict": counts.get(FLASH_KERNEL, 0) / per,
        "k1_ms_per_predict": kernel_ms("flash_fwd_kernel"),
        "top_device_ms_per_predict": {
            name: {"ms": us / 1e3 / per, "per_predict": cnt / per}
            for name, (us, cnt) in top},
        # where the host held the device back: the longest idle gaps
        # between device ops, and the host's CUDA API calls by time
        "longest_device_gaps": [
            {"ms": us / 1e3, "after": a[:100], "before": b[:100],
             "host_ops_at_middle": host_ops_at(mid)}
            for us, a, b, mid in sorted(gaps, key=lambda g: -g[0])[:6]],
        "gc_pauses_in_timed_predicts": gc_runs,
        "host_cuda_calls_ms_per_predict": {
            name: {"ms": us / 1e3 / per, "per_predict": cnt / per}
            for name, (us, cnt) in sorted(host_calls.items(),
                                          key=lambda kv: -kv[1][0])[:8]}}))


if __name__ == "__main__":
    main()
