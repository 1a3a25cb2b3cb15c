// Decode attention (K2): one query row per (batch, head) against that
// row's KV cache, for incremental decoding.
//
// Replaces the TPU kernel `_dec_kernel` / `_decode_flash` in
// mxnet_tpu/kernels/flash_attention.py:137-191 (reached from
// `_attention_decode(impl="pallas")`, mxnet_tpu/kernels/attention.py:110).
//
// What it computes, all in fp32: for each (b, h)
//   out[b,h,:] = softmax(q[b,h,:] . k[b,:n_b,h,:]^T * sm_scale) . v[b,:n_b,h,:]
// with n_b = lengths[b] clamped to S. Key positions at or past n_b get
// exactly zero weight, as the plain version's -1e30 mask gives them
// (exp underflows to +0.0). lengths[b] <= 0 leaves every key masked;
// the plain version then weighs all S keys alike, and so does this one.
//
// Layouts: q and out are (B, H, D); k and v are the decoder's caches
// (B, S, E) read as (B, S, H, D), E = H*D, so key row j of head h sits
// at k + (b*S + j)*E + h*D. The TPU path transposed both caches to
// (B, H, S, D) before its call, a full copy of both caches per step and
// layer; this kernel reads the cache layout in place and drops that copy.
//
// Bound: the kernel must read the visible keys and values once,
// sum_b n_b*H*D*4 bytes each, plus q and out (B*H*D*4 bytes each), and
// does about 4*sum_b n_b*H*D flops on them: 0.5 flop per byte, far below
// the card's balance, so it is bound by memory bytes at 3.35 TB/s
// (H100 SXM). What the design does about that bound:
//   - it stops at n_b instead of reading the masked tail: fewer bytes
//     for the same result;
//   - the TPU kernel held a whole (S, D) cache row in VMEM as one block;
//     at S = 1024, D = 64 that is 256 KB for K alone, above the 227 KB a
//     block may have, so here the block streams the row instead: each warp
//     scores kKeysPerStep keys per iteration (the loads of K and V rows for
//     all of them issued together, so several are in flight), keeps an
//     online softmax (running max, sum, accumulator) in fp32 registers,
//     and the warps combine once at the end through shared memory;
//   - lanes split D (lane l holds elements l, l+32, ...), so a warp reads
//     one key row as consecutive addresses; any D <= 256 works, lanes past
//     D are masked;
//   - the scalar prefetch of lengths becomes each block reading lengths[b].
// Known gap: the grid is one block per (b, h). At batch 1 that is only H
// blocks (12 at GPT-2 widths) on 132 SMs, so one decode step cannot reach
// the bandwidth bound there; splitting each row's keys over several blocks
// (split-K, with a second combine pass) is the fix, left to a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerStep = 8;
constexpr int kMaxD = 256;

template <int DPL>  // elements of D per lane: ceil(D / 32)
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ out,
                        int S, int H, int D, float sm_scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long E = (long long)H * D;

  int n = lengths[b];
  const bool all_masked = n <= 0;
  n = all_masked ? S : min(n, S);

  const float* qp = q + ((long long)b * H + h) * D;
  const long long base = (long long)b * S * E + (long long)h * D;
  const float* kp = k + base;
  const float* vp = v + base;

  float qr[DPL];
  bool on[DPL];
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    on[i] = d < D;
    qr[i] = on[i] ? qp[d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;  // running max of this warp's scores
  float l = 0.f;        // running sum of exp(score - m)

  for (int j0 = warp * kKeysPerStep; j0 < n; j0 += kWarps * kKeysPerStep) {
    float s[kKeysPerStep];
    float vr[kKeysPerStep][DPL];
#pragma unroll
    for (int t = 0; t < kKeysPerStep; ++t) {
      const int j = j0 + t;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        vr[t][i] = 0.f;
        if (j < n && on[i]) {
          const long long off = (long long)j * E + lane + 32 * i;
          part += qr[i] * kp[off];
          vr[t][i] = vp[off];
        }
      }
      s[t] = part;
    }
    // butterfly sums, interleaved over the keys so they overlap
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
#pragma unroll
      for (int t = 0; t < kKeysPerStep; ++t)
        s[t] += __shfl_xor_sync(0xffffffffu, s[t], w);
    }
    float mx = m;
#pragma unroll
    for (int t = 0; t < kKeysPerStep; ++t) {
      s[t] = all_masked ? 0.f : s[t] * sm_scale;
      if (j0 + t < n) mx = fmaxf(mx, s[t]);
    }
    // j0 < n, so key j0 is visible and mx is finite
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < kKeysPerStep; ++t) {
      if (j0 + t < n) {
        const float p = expf(s[t] - mx);
        l += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += p * vr[t][i];
      }
    }
    m = mx;
  }

  // combine the warps' partial softmaxes
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * DPL];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float scale[kWarps];
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no visible key has l = 0 and m = -inf
    scale[w] = sm_l[w] > 0.f ? expf(sm_m[w] - M) : 0.f;
    L += scale[w] * sm_l[w];
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  float* op = out + ((long long)b * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += scale[w] * sm_acc[w][d];
    op[d] = o * inv;
  }
}

template <int DPL>
void launch(const float* q, const float* k, const float* v,
            const int* lengths, float* out, int B, int H, int S, int D,
            float sm_scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  decode_attention_kernel<DPL><<<grid, kThreads, 0, stream>>>(
      q, k, v, lengths, out, S, H, D, sm_scale);
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream` and does not
// synchronize. Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int mxtt_decode_attention_f32(const float* q, const float* k,
                                         const float* v, const int* lengths,
                                         float* out, int B, int H, int S,
                                         int D, float sm_scale,
                                         void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > kMaxD || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: launch<1>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    case 2: launch<2>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    case 3: launch<3>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    case 4: launch<4>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    case 5: launch<5>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    case 6: launch<6>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    case 7: launch<7>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    case 8: launch<8>(q, k, v, lengths, out, B, H, S, D, sm_scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
