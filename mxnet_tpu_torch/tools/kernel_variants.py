"""Ablations of K1 and K2 on the card: the committed kernels beside
copies with one design choice undone.

Each variant is the committed source (``csrc/flash_attention.cu`` or
``csrc/decode_attention.cu``) with a text substitution, built by
``nvcc`` with the port's flags into ``build/mxnet_tpu_torch/variants/``
(all builds started together) and called through its C entry point at
the main path's shapes:

- ``k1``: K1 as committed;
- ``k1-one-accumulator``: P.V summed into O across all tiles, not per
  tile from zero;
- ``k1-interleaved-passes``: Q.K^T's three passes taken per k-step, not
  every small term before the big.big terms;
- ``k1-cvt-rna``: TF32 rounding by ``cvt.rna.tf32.f32`` instead of the
  integer form of the same rounding;
- ``k1-4-warps``: 4 warps (64 query rows) per block at D <= 64, 2 blocks
  per SM;
- ``k1-bk32``: 32 keys per tile at D <= 64;
- ``k2``: K2 as committed; ``k2-4-warps``: four warps per block;
- ``sm90``: K1's wgmma kernel for bf16 at D = 64
  (``csrc/flash_attention_sm90.cu``) as committed;
- ``sm90-one-pass``: P rounded to bf16 and one P.V pass (what the second
  pass costs; its error leaves the two-ulp gate);
- ``sm90-round-hi``: P_hi rounded to nearest rather than cut, P_lo from
  that;
- ``sm90-no-overlap``: a warpgroup waits for its P.V before the softmax,
  so the softmax runs under the other warpgroup's products only;
- ``sm90-all-masked``: every tile through the masked softmax;
- ``sm90-2-stages``: two K/V stages in the ring instead of three.

The named barriers' turns are not undone: the sm90 kernel's releases of
the tiles a warpgroup skips rely on them.

For every variant it prints the registers and spills ``ptxas`` reports
for the main path's instantiation (fp32, D = 64; the sm90 kernel) and,
for each shape, the
largest difference from the plain version and the median device ms of
25 launches (L2 evicted and the stream kept busy before each, as
``chip_smoke.py`` times). K1's shapes are the training shape (8, 12,
1024, 1024, 64, causal) and the fusion route's (128, 1, 499, 499, 64); the
sm90 kernel's is the training shape in bf16, its error taken against
the plain version in fp32 rounded to bf16; K2's are B in {1, 8, 32}, H
12, S 1024, D 64. Run from the root of a checkout, on a machine with
one NVIDIA GPU (``--only sm90`` builds and times only the variants whose
names start so):

    python3 -m mxnet_tpu_torch.tools.kernel_variants [--only sm90]

It needs no network and writes only the builds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess

import torch

from ..kernels import _build
from ..kernels import flash_attention as fa

K1_SRC, K2_SRC = "flash_attention", "decode_attention"
SM90_SRC = "flash_attention_sm90"
_SM90_PV_LO = ("for (int kk = 0; kk < kBK / 16; ++kk) "
               "wgmma_pv(o, pl[kk], dv + 128 * kk);")
_SM90_SPLIT = """          ph[kk][r] = __byte_perm(xb, yb, 0x7632);  // the high halves
          pl[kk][r] = bf2_bits(
              __floats2bfloat162_rn(x - __uint_as_float(xb & 0xffff0000u),
                                    y - __uint_as_float(yb & 0xffff0000u)));"""
VARIANTS = {
    "k1": (K1_SRC, []),
    "k1-one-accumulator": (K1_SRC, [
        ("constexpr bool kTileAcc = DP <= 64;",
         "constexpr bool kTileAcc = false;")]),
    "k1-interleaved-passes": (K1_SRC, [
        ("pass < (kF32 ? 2 : 1)", "pass < 1"),
        ("          mma(s[j], ab, bits(kl.x), bits(kl.y));\n",
         "          mma(s[j], ab, bits(kl.x), bits(kl.y));\n"
         "          mma(s[j], ab, bits(kb.x), bits(kb.y));\n")]),
    "k1-cvt-rna": (K1_SRC, [
        ("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
         "  uint32_t r;\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
         "  return r;")]),
    "k1-4-warps": (K1_SRC, [
        ("kWarps = DP <= 64 ? 8 : 4;", "kWarps = 4;"),
        ("kMinBlocks = DP <= 64 ? 1 : 2;", "kMinBlocks = 2;")]),
    "k1-bk32": (K1_SRC, [
        ("return launch<T, 64, 64>(", "return launch<T, 64, 32>(")]),
    "sm90": (SM90_SRC, []),
    "sm90-one-pass": (SM90_SRC, [
        (_SM90_PV_LO, ""),
        (_SM90_SPLIT, "          ph[kk][r] = bf2_bits("
                      "__floats2bfloat162_rn(x, y));")]),
    "sm90-round-hi": (SM90_SRC, [
        (_SM90_SPLIT, """          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hv = __bfloat1622float2(hi);
          ph[kk][r] = bf2_bits(hi);
          pl[kk][r] = bf2_bits(__floats2bfloat162_rn(x - hv.x, y - hv.y));""")]),
    "sm90-no-overlap": (SM90_SRC, [
        ("      wg_wait<1>();\n", "      wg_wait<0>();\n")]),
    "sm90-all-masked": (SM90_SRC, [
        ("      const int n_full =\n          min(n_wg,",
         "      const int n_full = 0 * min(n_wg,")]),
    "sm90-2-stages": (SM90_SRC, [
        ("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
    "k2": (K2_SRC, []),
    "k2-4-warps": (K2_SRC, [
        ("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")]),
}
K1_SHAPES = {"training": (8, 12, 1024, 1024, 64, True),
             "route": (128, 1, 499, 499, 64, False)}
K2_BATCHES = (1, 8, 32)
# the main path's instantiation in ptxas's log
MAIN_KERNEL = {K1_SRC: "flash_fwd_kernelIfLi64E",
               K2_SRC: "decode_attention_kernelILi2E",
               SM90_SRC: "flash_fwd_sm90"}
SM90_SHAPES = {"training_bf16": (8, 12, 1024, 1024, 64, True)}
REPS = 25
BUSY_CYCLES = 400_000
VARIANT_DIR = os.path.join(_build.BUILD_DIR, "variants")


def build(names):
    """Write and compile each variant; returns {name: (CDLL, ptxas line)}."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, subs = VARIANTS[name]
        with open(os.path.join(_build.CSRC_DIR, src + ".cu")) as f:
            text = f.read()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"kernel_variants: {name}: {old!r} is not "
                                 f"in {src}.cu")
            text = text.replace(old, new)
        path = os.path.join(VARIANT_DIR, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(VARIANT_DIR, name + ".so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise SystemExit(f"kernel_variants: {name} failed to build:\n"
                             f"{log[-4000:]}")
        main = MAIN_KERNEL[VARIANTS[name][0]]
        lines = log.splitlines()
        at = [i for i, line in enumerate(lines)
              if "Compiling entry" in line and main in line]
        usage = " ".join(
            re.sub(r"\s*ptxas info\s*:\s*", "", line).strip()
            for line in lines[at[0] + 1:at[0] + 4]
            if "spill" in line or "registers" in line) if at else "not found"
        out[name] = (ctypes.CDLL(os.path.join(VARIANT_DIR, name + ".so")),
                     usage)
    return out


def time_ms(fn, flush):
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


def k1_call(lib, q, k, v, scale, causal):
    fn = lib.mxtt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int]
    B, H, S_q, D = q.shape
    out = torch.empty(B, H, S_q, D, device=q.device)
    st = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                   for i in range(3)))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, B,
             H, S_q, k.shape[2], D, ctypes.cast(st, ctypes.c_void_p), scale,
             int(causal), torch.cuda.current_stream().cuda_stream,
             fa._flash_load_width(k, v))
    if err:
        raise RuntimeError(f"K1 variant launch failed: CUDA error {err}")
    return out


def sm90_call(lib, q, k, v, scale, causal):
    fn = lib.mxtt_flash_attention_sm90_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    B, H, S_q, D = q.shape
    out = torch.empty(B, H, S_q, D, dtype=q.dtype, device=q.device)
    st = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                   for i in range(3)))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
             H, S_q, k.shape[2], ctypes.cast(st, ctypes.c_void_p), scale,
             int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sm90 variant launch failed: CUDA error {err}")
    return out


def k2_call(lib, q, k, v, n, scale, n_sm):
    fn = lib.mxtt_decode_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
        [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int]
    B, S, H, D = k.shape
    splits, chunk = fa._decode_splits(B, H, S, n_sm)
    part = torch.empty(B * H * splits * (D + 2), device=q.device) \
        if splits > 1 else None
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(),
             out.data_ptr(), B, H, S, D, scale,
             torch.cuda.current_stream().cuda_stream,
             None if part is None else part.data_ptr(), splits, chunk)
    if err:
        raise RuntimeError(f"K2 variant launch failed: CUDA error {err}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="build and time only the variants whose names "
                         "start with this")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build([n for n in VARIANTS if n.startswith(args.only)])
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(20240917)
    flush = torch.empty(64 * 2 ** 20, device=dev)
    rows = {name: {"ptxas": usage} for name, (_, usage) in libs.items()}
    for shape, (B, H, S_q, S_k, D, causal) in K1_SHAPES.items():
        q, k, v = (torch.randn(B, H, s, D, device=dev, generator=gen)
                   for s in (S_q, S_k, S_k))
        ref = fa._flash_ref(q, k, v, D ** -0.5, causal)
        for name, (lib, _) in libs.items():
            if VARIANTS[name][0] != K1_SRC:
                continue
            run = lambda: k1_call(lib, q, k, v, D ** -0.5, causal)  # noqa
            rows[name][shape] = {
                "max_abs_err": (run() - ref).abs().max().item(),
                "ms": time_ms(run, flush)}
    for shape, (B, H, S_q, S_k, D, causal) in SM90_SHAPES.items():
        q, k, v = (torch.randn(B, H, s, D, device=dev, generator=gen)
                   .bfloat16() for s in (S_q, S_k, S_k))
        ref = fa._flash_ref(q.float(), k.float(), v.float(), D ** -0.5,
                            causal).bfloat16().float()
        for name, (lib, _) in libs.items():
            if VARIANTS[name][0] != SM90_SRC:
                continue
            run = lambda: sm90_call(lib, q, k, v, D ** -0.5, causal)  # noqa
            rows[name][shape] = {
                "max_abs_err": (run().float() - ref).abs().max().item(),
                "ms": time_ms(run, flush)}
    for B in K2_BATCHES:
        H, S, D = 12, 1024, 64
        q = torch.randn(B, H, D, device=dev, generator=gen)
        k, v = (torch.randn(B, S, H, D, device=dev, generator=gen)
                for _ in range(2))
        n = torch.full((B,), S, dtype=torch.int32, device=dev)
        ref = fa._decode_flash_ref(q, k, v, n, D ** -0.5)
        for name, (lib, _) in libs.items():
            if VARIANTS[name][0] != K2_SRC:
                continue
            run = lambda: k2_call(lib, q, k, v, n, D ** -0.5, n_sm)  # noqa
            rows[name][f"B={B}"] = {
                "max_abs_err": (run() - ref).abs().max().item(),
                "ms": time_ms(run, flush)}
    for name, row in rows.items():
        print(json.dumps({"variant": name, **row}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
