"""The sm90 route of N2 under every launch plan, against the plan the
wrapper's cost model picks.

``_sm90_plan`` (``kernels/int8_conv.py``) chooses each convolution's tile
width (64, 128 or 256 filters) and K split (1, 2 or 4 parts, atomics
where K is split) from a cost model of the busiest block. This tool times
the sm90 kernel at each distinct ``resnet50_v1`` convolution at batch 32
(the stem, which the route rule keeps on the ``mma.sync`` kernel, left
out) under every plan the model may choose from, through the wrapper
(its layout copy, the same under every plan, included), and prints one
JSON line per shape (each plan's
median device ms, the model's pick, the fastest), then the card's name
and power limit and one JSON summary: the forward's sum on the model's
picks and on the fastest plan of each shape, and at how many shapes the
two agree. Every plan's output is first checked bitwise against the
plain version. Times are medians of 25 launches, each alone between CUDA
events after a 256 MB write that evicts the L2, as ``chip_smoke.py``
times. Run from the root of a checkout, on a machine with one NVIDIA
GPU:

    python3 -m mxnet_tpu_torch.tools.n2_plans [--batch 32]

It needs no network and writes only the kernels' builds.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

REPS = 25
BUSY_CYCLES = 400_000  # ~200 us at 1.98 GHz: longer than a launch's host cost


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    import torch

    from ..base import MXNetError
    from ..kernels import _build
    from ..kernels import int8_conv as k8
    from .profile_quant import resnet50_convolutions

    if not torch.cuda.is_available():
        raise SystemExit("n2_plans: no CUDA device")
    _build.build_all([k8.SM90_KERNEL])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(20240917)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def time_ms(fn):
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

    convs = resnet50_convolutions(args.batch)
    rows, picked, best = [], 0.0, 0.0
    agree = 0
    for c in dict.fromkeys(convs):
        x_s, w_s, st, p = c
        x, w = (torch.randint(-127, 128, s, generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
                for s in (x_s, w_s))
        if k8._int8_conv_route(x, w, 1, st) != "sm90":
            continue
        d = (1, 1)
        want = k8._int8_conv_ref(x, w, st, p, d, 1)
        pick = k8._sm90_plan(x_s, w_s, st, p, d, n_sm)
        times = {}
        for bn in (64, 128, 256):
            for splits in (1, 2, 4):
                try:
                    plan = k8._sm90_plan(x_s, w_s, st, p, d, n_sm, bn=bn,
                                         splits=splits)
                except MXNetError:  # more splits than k-tiles
                    continue
                if splits > 1 and plan["k_tiles"] // splits < 4:
                    continue
                if not torch.equal(
                        k8._int8_conv_sm90(x, w, st, p, d, plan), want):
                    raise RuntimeError(f"n2_plans: {c} differs from the "
                                       f"plain version at {bn}/{splits}")
                times[f"{bn}/{splits}"] = time_ms(
                    lambda: k8._int8_conv_sm90(x, w, st, p, d, plan))
        key = f"{pick['bn']}/{pick['splits']}"
        fastest = min(times, key=times.get)
        n = convs.count(c)
        picked += n * times[key]
        best += n * times[fastest]
        agree += key == fastest
        rows.append(c)
        print(json.dumps({"x": x_s, "w": w_s, "stride": st, "count": n,
                          "tile": pick["tile"], "pick": key,
                          "fastest": fastest, "ms": times}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"card": smi, "batch": args.batch, "shapes": len(rows),
                      "model_pick_is_fastest": agree,
                      "forward_ms_model_picks": picked,
                      "forward_ms_fastest_plans": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
