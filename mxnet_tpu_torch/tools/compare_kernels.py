"""K1, K2 and N2 of two checkouts of the port, timed in turns on one card.

Each tree named on the command line is timed in its own child process,
in the order given (for a before/after comparison: parent, change,
change, parent). A child imports ``mxnet_tpu_torch`` from its tree, so
it builds and launches that tree's kernels through that tree's wrappers
(``_flash_fwd_cuda``, ``_decode_flash``), and times, at the shapes of
``chip_smoke.py``'s phases 4, 7 and 12:

- K1 at the training shape (8, 12, 1024, 1024, 64, causal) in float32
  and in bfloat16 (the LM under AMP; from this tree on, bf16 at D = 64
  takes the wgmma kernel, ``csrc/flash_attention_sm90.cu``) and on the
  fusion route's (128, 1, 499, 499, 64), with
  ``scaled_dot_product_attention`` beside it (a yardstick only);
- K2 at B in {1, 8, 32}, H 12, S 1024, D 64, every key visible, with
  SDPA under a boolean mask beside it;
- N2 per ``resnet50_v1`` forward at batch 32: its 53 int8 convolutions
  (20 distinct shapes, each timed alone and counted as often as the
  network holds it) through ``int8_conv``, on each route of
  ``--n2-routes`` in the order given (``default``: the tree's own route
  rule; ``mma`` or ``sm90``: ``route=``, from the tree that has the sm90
  kernel on), each checked bitwise against the plain version at batch 2
  first.

Every time is the median device ms of 25 launches, each alone between
CUDA events after a 256 MB write that evicts the L2 and a
``torch.cuda._sleep`` that keeps the stream busy until the launch is
enqueued. Each child also checks its kernels against the plain versions
(1e-5; in bfloat16 two bf16 ulps, rtol 2^-6, of the plain version in
float32 rounded once). Prints one JSON line per turn, then the card's name and power
limit and one JSON summary with the medians over the turns of each
tree. Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.compare_kernels \
        build/parent . . build/parent
    python3 -m mxnet_tpu_torch.tools.compare_kernels . --kernels n2 \
        --n2-routes mma sm90 sm90 mma

It needs no network and writes only the trees' kernel builds.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPS = 25
BUSY_CYCLES = 400_000  # ~200 us at 1.98 GHz: longer than a launch's host cost
K1_SHAPES = {"training": (8, 12, 1024, 1024, 64, True, "float32"),
             "training_bf16": (8, 12, 1024, 1024, 64, True, "bfloat16"),
             "route": (128, 1, 499, 499, 64, False, "float32")}
K2_BATCHES = (1, 8, 32)
K2_H, K2_S, K2_D = 12, 1024, 64
TOL = 1e-5
BF16_RTOL = 2.0 ** -6


def _time_ms(torch, fn, flush):
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(BUSY_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def n2_per_forward(torch, flush, gen, routes):
    """``{f"n2_{route}_ms": ms}``: N2 per resnet50_v1 forward at batch 32
    on each of ``routes``, in that order (a route named twice is timed
    twice: the median of its turns, and every turn under ``n2_turns``);
    each turn first checked bitwise against the plain version at batch
    2."""
    from mxnet_tpu_torch.kernels import int8_conv as k8
    from mxnet_tpu_torch.tools.profile_quant import resnet50_convolutions

    def s8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    def conv(x, w, st, p, route):
        if route == "default":
            return k8.int8_conv(x, w, st, p, (1, 1), 1)
        return k8.int8_conv(x, w, st, p, (1, 1), 1, route=route)

    convs = resnet50_convolutions(32)
    distinct = list(dict.fromkeys(convs))
    counts = {c: convs.count(c) for c in distinct}
    operands = {c: (s8(c[0]), s8(c[1])) for c in distinct}
    out = {}
    turns = {}
    for route in routes:
        for x_s, w_s, st, p in dict.fromkeys(resnet50_convolutions(2)):
            x, w = s8(x_s), s8(w_s)
            if route == "sm90" and \
                    k8._int8_conv_route(x, w, 1, st) != "sm90":
                continue
            if not torch.equal(conv(x, w, st, p, route),
                               k8._int8_conv_ref(x, w, st, p, (1, 1), 1)):
                raise RuntimeError(f"N2 ({route}) differs from its plain "
                                   f"version at {x_s} {w_s}")
        total = 0.0
        for c in distinct:
            x, w = operands[c]
            r = route
            if r == "sm90" and k8._int8_conv_route(x, w, 1, c[2]) != "sm90":
                r = "mma"  # the stem: the rule keeps it on mma
            total += counts[c] * _time_ms(
                torch, lambda: conv(x, w, c[2], c[3], r), flush)
        turns.setdefault(route, []).append(total)
    for route, ts in turns.items():
        out[f"n2_{route}_ms"] = statistics.median(ts)
    out["n2_turns"] = turns
    return out


def child(tree, kernels, n2_routes):
    """Time one tree's kernels; print one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    assert os.path.abspath(fa.__file__).startswith(os.path.abspath(tree))
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20240917)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"tree": tree}
    if "n2" in kernels:
        out.update(n2_per_forward(torch, flush, gen, n2_routes))
    for name, (B, H, S_q, S_k, D, causal, dtype) in (
            K1_SHAPES.items() if "k1" in kernels else ()):
        dtype = getattr(torch, dtype)
        q, k, v = (torch.randn(B, H, s, D, device=dev, generator=gen)
                   .to(dtype) for s in (S_q, S_k, S_k))
        scale = D ** -0.5
        got = fa._flash_fwd_cuda(q, k, v, scale, causal).float()
        want = fa._flash_ref(q.float(), k.float(), v.float(), scale,
                             causal).to(dtype).float()
        err = (got - want).abs().max().item()
        rtol = TOL if dtype == torch.float32 else BF16_RTOL
        if not torch.allclose(got, want, rtol=rtol, atol=TOL):
            raise RuntimeError(f"{tree}: K1 off by {err} at {name}")
        out[f"k1_{name}_ms"] = _time_ms(
            torch, lambda: fa._flash_fwd_cuda(q, k, v, scale, causal), flush)
        out[f"sdpa_{name}_ms"] = _time_ms(
            torch, lambda: sdpa(q, k, v, is_causal=causal, scale=scale),
            flush)
        out[f"k1_{name}_max_abs_err"] = err
        del q, k, v
    for B in (K2_BATCHES if "k2" in kernels else ()):
        H, S, D = K2_H, K2_S, K2_D
        q = torch.randn(B, H, D, device=dev, generator=gen)
        k, v = (torch.randn(B, S, H, D, device=dev, generator=gen)
                for _ in range(2))
        n = torch.full((B,), S, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        err = (fa._decode_flash(q, k, v, n, scale)
               - fa._decode_flash_ref(q, k, v, n, scale)).abs().max().item()
        if err > TOL:
            raise RuntimeError(f"{tree}: K2 off by {err} at B={B}")
        mask = torch.ones(B, 1, 1, S, dtype=torch.bool, device=dev)
        out[f"k2_b{B}_ms"] = _time_ms(
            torch, lambda: fa._decode_flash(q, k, v, n, scale), flush)
        out[f"sdpa_decode_b{B}_ms"] = _time_ms(
            torch, lambda: sdpa(q[:, :, None], k.transpose(1, 2),
                                v.transpose(1, 2), attn_mask=mask,
                                scale=scale), flush)
        out[f"k2_b{B}_max_abs_err"] = err
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="checkouts, timed in this order")
    ap.add_argument("--kernels", nargs="+", default=["k1", "k2", "n2"],
                    choices=("k1", "k2", "n2"))
    ap.add_argument("--n2-routes", nargs="+", default=["default"],
                    choices=("default", "mma", "sm90"),
                    help="N2's routes, timed in this order in each tree")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.kernels, args.n2_routes)
    if not args.trees:
        ap.error("name at least one tree")
    turns = []
    for tree in args.trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", tree, "--kernels", *args.kernels,
                              "--n2-routes", *args.n2_routes],
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            raise SystemExit(f"compare_kernels: the turn of {tree} failed "
                             f"({res.returncode})")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    summary = {}
    for tree in dict.fromkeys(args.trees):
        rows = [t for t in turns if t["tree"] == tree]
        summary[tree] = {key: statistics.median(r[key] for r in rows)
                         for key in rows[0] if key.endswith("_ms")}
        summary[tree]["turns"] = {key: [r[key] for r in rows]
                                  for key in rows[0] if key.endswith("_ms")}
    print(json.dumps({"card": smi, "medians_over_turns": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
