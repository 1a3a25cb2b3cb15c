"""Top self-time device operations from a profiler capture.

The PyTorch counterpart of ``mxnet_tpu/tools/trace_top.py``. It reads
the device trace ``profiler.stop()`` writes (torch.profiler's Chrome
JSON, ``<stem>_device.json``, in place of the JAX package's XPlane
capture) and prints a per-operation self-time table: the card's kernels
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) when the trace has
any, else the CPU operators (``cpu_op``), as on a machine without a
card. Reference analog: the profiler aggregate-stats dump
(src/profiler/aggregate_stats.cc PrintStats).

  python -m mxnet_tpu_torch.tools.trace_top profile_device.json [-n 25] [--by name]
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os

#: event categories of the card's own work in a kineto trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path):
    """Accept a device-trace file or a directory holding one."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*_device.json*"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no *_device.json under {path}")
    return hits[-1]  # newest capture


def load_events(trace_file):
    op = gzip.open if trace_file.endswith(".gz") else open
    with op(trace_file, "rt") as f:
        doc = json.load(f)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def device_op_events(events):
    """Complete ('X') events of the card's work; the CPU operators when
    the trace holds none."""
    done = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in done if e.get("cat") in DEVICE_CATS]
    return dev or [e for e in done if e.get("cat") == "cpu_op"]


def _family(name):
    """Collapse template, argument and launch noise: 'void foo<float,
    4>(...)' -> 'foo', 'aten::addmm' -> 'addmm', 'std::enable_if<...>::type
    at::native::(anonymous namespace)::bar<...>(...)' -> 'bar',
    'ampere_sgemm_128x64_nn' -> 'ampere_sgemm'."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    # the function's name: outside template arguments, before its
    # parameter list, after any return type
    depth, kept = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            kept.append(ch)
    base = "".join(kept).strip()
    if "::" in base:
        base = base.split(" ")[-1].split("::")[-1]
    head = "_".join(base.split("_")[:2]) if base.count("_") > 2 else base
    return head or name


def summarize(events, by="family"):
    tot = collections.Counter()
    cnt = collections.Counter()
    for e in events:
        key = e["name"] if by == "name" else _family(e["name"])
        tot[key] += e["dur"]  # microseconds
        cnt[key] += 1
    return tot, cnt


def table(events, n=20, by="family"):
    """The printed table's lines (header included)."""
    tot, cnt = summarize(events, by)
    grand = sum(tot.values()) or 1
    lines = [f"# {len(events)} device events, "
             f"{grand / 1e3:.2f} ms total self time",
             f"{'self_ms':>10} {'%':>6} {'count':>7}  op"]
    for key, us in tot.most_common(n):
        lines.append(f"{us / 1e3:10.3f} {100.0 * us / grand:6.2f} "
                     f"{cnt[key]:7d}  {key}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="device trace file or a directory")
    ap.add_argument("-n", type=int, default=20, help="rows to print")
    ap.add_argument("--by", choices=("family", "name"), default="family",
                    help="aggregate by op family (default) or full name")
    args = ap.parse_args(argv)

    trace = find_trace(args.trace)
    events = device_op_events(load_events(trace))
    print(f"# {trace}")
    for line in table(events, args.n, args.by):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
