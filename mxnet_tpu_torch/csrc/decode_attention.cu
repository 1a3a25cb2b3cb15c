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
//     block may have, so here the block streams the row instead: each of
//     its eight warps scores kKeysPerStep = 8 keys per iteration (the
//     loads of K and V rows for all of them issued together, so several
//     are in flight), keeps an online softmax (running max, sum,
//     accumulator) in fp32 registers, and the warps combine once at the
//     end through shared memory. Eight warps, not four: at B = 32 (one
//     split, 384 blocks) four left most of each SM's warp slots empty and
//     reached 45% of the bound; four are 1.26x (B = 1) to 1.62x (B = 32)
//     slower (tools/kernel_variants.py). ptxas gives the D = 64
//     instantiation 64 registers and an 8-byte spill;
//   - lanes split D (lane l holds elements l, l+32, ...), so a warp reads
//     one key row as consecutive addresses; any D <= 256 works, lanes past
//     D are masked;
//   - the scalar prefetch of lengths becomes each block reading lengths[b].
// Split of the key sweep (flash-decoding): the grid is (H, B, splits).
// One block per (b, h) gives H blocks at batch 1, 12 at GPT-2 widths on
// 132 SMs, far from the bandwidth bound. So the wrapper cuts each row's
// S positions into `splits` chunks of `chunk` keys (`_decode_splits` in
// mxnet_tpu_torch/kernels/flash_attention.py, from B, H, S and the SM
// count alone: B*H*splits >= 2 x 132 blocks, chunks of a multiple of 64
// keys, one step of the eight warps; 16 splits at B = 1, S = 1024, 3 at
// B = 8, 1 at B = 32). Block c sweeps
// keys [c*chunk, min((c+1)*chunk, n_b)) as above and writes its partial
// (m, l, acc[D]), unnormalized, to an fp32 scratch tensor; a second
// kernel weighs each chunk by exp(m_c - M) and divides by
// sum_c l_c*exp(m_c - M), M the largest m_c. A chunk that starts at or
// past n_b writes m = -inf and l = 0 and gets weight 0 (never a NaN);
// with lengths[b] <= 0 the chunks cover all S keys, weighed alike. With
// one split the combine is not launched and the block writes `out` as
// before. So a call is one or two kernel launches; the wrapper counts it
// once. The bound is unchanged: the visible K and V are still read once;
// the split adds the partials, B*H*splits*(D+2)*4 bytes written and read
// back (50.7 KB each way at B = 1, S = 1024, against 6.3 MB of cache).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
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
                        float* __restrict__ partial,
                        int S, int H, int D, int chunk, float sm_scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;  // this block's chunk of the key sweep
  const int splits = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long E = (long long)H * D;

  int n = lengths[b];
  const bool all_masked = n <= 0;
  n = all_masked ? S : min(n, S);
  const int j_begin = c * chunk;
  const int j_end = min(j_begin + chunk, n);  // <= j_begin: no key here

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

  for (int j0 = j_begin + warp * kKeysPerStep; j0 < j_end;
       j0 += kWarps * kKeysPerStep) {
    float s[kKeysPerStep];
    float vr[kKeysPerStep][DPL];
#pragma unroll
    for (int t = 0; t < kKeysPerStep; ++t) {
      const int j = j0 + t;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        vr[t][i] = 0.f;
        if (j < j_end && on[i]) {
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
      if (j0 + t < j_end) mx = fmaxf(mx, s[t]);
    }
    // j0 < j_end, so key j0 is visible and mx is finite
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < kKeysPerStep; ++t) {
      if (j0 + t < j_end) {
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
  const long long row = (long long)b * H + h;
  if (splits == 1) {
    const float inv = 1.f / fmaxf(L, 1e-30f);
    float* op = out + row * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += scale[w] * sm_acc[w][d];
      op[d] = o * inv;
    }
    return;
  }
  // partial of chunk c: m, l, then acc[D], unnormalized; an empty chunk
  // writes M = -inf, L = 0 and zeros
  float* pp = partial + (row * splits + c) * (D + 2);
  if (threadIdx.x == 0) {
    pp[0] = M;
    pp[1] = L;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += scale[w] * sm_acc[w][d];
    pp[2 + d] = o;
  }
}

// out[b, h] from the `splits` partials of row (b, h): chunk c weighs
// exp(m_c - M), and chunks with l_c = 0 (no visible key) weigh 0
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ partial,
                      float* __restrict__ out, int H, int D, int splits) {
  const long long row = (long long)blockIdx.y * H + blockIdx.x;
  const float* pp = partial + row * splits * (D + 2);
  float M = -INFINITY;
  for (int c = 0; c < splits; ++c)
    if (pp[c * (D + 2) + 1] > 0.f) M = fmaxf(M, pp[c * (D + 2)]);
  float L = 0.f;
  for (int c = 0; c < splits; ++c) {
    const float lc = pp[c * (D + 2) + 1];
    if (lc > 0.f) L += lc * expf(pp[c * (D + 2)] - M);
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
    for (int c = 0; c < splits; ++c) {
      const float* pc = pp + c * (D + 2);
      if (pc[1] > 0.f) o += expf(pc[0] - M) * pc[2 + d];
    }
    out[row * D + d] = o * inv;
  }
}

template <int DPL>
void launch(const float* q, const float* k, const float* v,
            const int* lengths, float* out, float* partial, int B, int H,
            int S, int D, int splits, int chunk, float sm_scale,
            cudaStream_t stream) {
  const dim3 grid(H, B, splits);
  decode_attention_kernel<DPL><<<grid, kThreads, 0, stream>>>(
      q, k, v, lengths, out, partial, S, H, D, chunk, sm_scale);
}

}  // namespace

// C entry point (bound with ctypes). splits and chunk: the key sweep of
// each (b, h) runs in `splits` blocks of `chunk` keys, splits * chunk >= S
// and (splits - 1) * chunk < S; with splits > 1, `partial` is fp32
// scratch of B * H * splits * (D + 2) floats and a second kernel writes
// `out`; with splits = 1 `partial` is not read and may be null. Launches
// on `stream` and does not synchronize. Returns cudaGetLastError() after
// the launches: 0 on success.
extern "C" int mxtt_decode_attention_f32(const float* q, const float* k,
                                         const float* v, const int* lengths,
                                         float* out, int B, int H, int S,
                                         int D, float sm_scale,
                                         void* stream, float* partial,
                                         int splits, int chunk) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > kMaxD || B > 65535 ||
      splits <= 0 || splits > 65535 || chunk <= 0 ||
      (long long)splits * chunk < S || (long long)(splits - 1) * chunk >= S ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
#define MXTT_CASE(n)                                                       \
    case n:                                                                \
      launch<n>(q, k, v, lengths, out, partial, B, H, S, D, splits, chunk, \
                sm_scale, st);                                             \
      break;
    MXTT_CASE(1) MXTT_CASE(2) MXTT_CASE(3) MXTT_CASE(4)
    MXTT_CASE(5) MXTT_CASE(6) MXTT_CASE(7) MXTT_CASE(8)
#undef MXTT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_combine_kernel<<<dim3(H, B), kThreads, 0, st>>>(partial, out, H,
                                                           D, splits);
  }
  return (int)cudaGetLastError();
}
