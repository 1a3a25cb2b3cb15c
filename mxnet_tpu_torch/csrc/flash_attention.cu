// Flash-attention forward (K1): scaled dot-product attention over
// (B, H, S, D) tensors with an online softmax, for training.
//
// Replaces the TPU kernel `_fa_kernel`, launched by `_pallas_forward`, in
// mxnet_tpu/kernels/flash_attention.py:48-134 (reached from
// `nd.flash_attention`, mxnet_tpu/ndarray/ops_nn.py:727, on the path of
// `TransformerLM`, mxnet_tpu/models/transformer.py:58).
//
// What it computes, for each (b, h) and query row i:
//   out[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h,j,:] * sm_scale) . v[b,h,:,:]
// over keys j < S_k and, when causal, j <= i + (S_k - S_q): the causal
// mask is aligned bottom-right, as the TPU kernel's is. Scores are summed
// and the softmax kept in fp32 (running max m, sum l and accumulator per
// row) across the sweep over key tiles; masked scores are -1e30, so they
// get exactly zero weight; the output is acc / max(l, 1e-30), cast to
// q's dtype. Inputs are fp32 or bf16 (converted to fp32 as they are
// loaded). All products are fp32 FMAs, never TF32: the JAX package holds
// its kernel to 1e-5 of the plain path, and TF32 keeps about 3 digits.
//
// Layout: q, k and v are read through their (b, h, s) strides with D
// contiguous, so the model's q/k/v views of one fused qkv projection
// are read in place, without a copy. out is a fresh contiguous
// (B, H, S_q, D) tensor.
//
// Bound: at the training path's shape (B 8, H 12, S 1024, D 64, causal)
// the visible (query, key) pairs are B*H*S*(S+1)/2, each costing 2*D
// flops for q.k and 2*D for p.v: 12.9 GFLOP, 0.193 ms at the card's
// 67 TFLOP/s of fp32, against 100.7 MB of q, k, v and out, 0.030 ms at
// 3.35 TB/s. So it is bounded by operations. What the design does about
// that bound:
//   - the TPU grid's sequential key axis, with (m, l, acc) carried in
//     scratch across grid steps, becomes a loop inside one block; a
//     block owns one (b, h, tile of BQ query rows) and keeps m, l and acc
//     in registers for the whole sweep;
//   - each thread computes an RQ x (BK/8) tile of scores and an
//     RQ x (DP/8) tile of the output (register blocking, as in a SIMT
//     GEMM): Q and P are stored transposed in shared memory and K^T
//     too, so every inner step reads its operands as 16-byte vectors
//     without bank conflicts and issues RQ*BK/8 (or RQ*DP/8) FMAs for
//     every 1 + BK/32 (or 1 + DP/32) vector loads;
//   - when causal, the key loop stops at the last tile the query tile
//     can see (the TPU kernel's skip of tiles above the diagonal), and
//     blocks take query tiles from the bottom up, so the longest tiles
//     start first and the last wave is short;
//   - ragged S_q and S_k are masked in the kernel instead of padded by
//     copies (the TPU path's jnp.pad), and D is padded to DP (32, 64,
//     128 or 256) with zeros in shared memory only;
//   - the K/V tile is sized by D so that shared memory stays under the
//     227 KB a block may have (43-111 KB; above 48 KB it is opted into
//     with cudaFuncSetAttribute).
// Left for later: tensor cores (wgmma on bf16 inputs; TF32 would break
// the fp32 parity bound), TMA loads and a double-buffered K/V ring.
//
// The gradient is not a kernel: the JAX package's backward
// (`_flash_bwd`, flash_attention.py:206-245) is an XLA q-chunk
// recompute, not Pallas, so the port's backward is the same recompute
// in PyTorch (`_flash_bwd` in mxnet_tpu_torch/kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N contiguous floats from (or to) shared memory as one vector access;
// the address is 4N-byte aligned by construction.
template <int N>
__device__ __forceinline__ void lds(const float* p, float* r);
template <>
__device__ __forceinline__ void lds<4>(const float* p, float* r) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
}
template <>
__device__ __forceinline__ void lds<2>(const float* p, float* r) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  r[0] = t.x; r[1] = t.y;
}
template <int N>
__device__ __forceinline__ void sts(float* p, const float* r);
template <>
__device__ __forceinline__ void sts<4>(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
template <>
__device__ __forceinline__ void sts<2>(float* p, const float* r) {
  *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
}

// DP: D padded to a multiple of 32; RQ: query rows per thread (BQ = 16 RQ
// rows per block); BK: keys per tile.
template <int DP, int RQ, int BK>
struct Tile {
  static constexpr int BQ = 16 * RQ;
  static constexpr int QT = BQ + 4;  // row stride of Q^T and P^T
  static constexpr int KT = BK + 4;  // row stride of K^T
  static constexpr int NS = BK / 8;  // score columns per thread
  static constexpr int NO = DP / 8;  // output columns per thread
  static constexpr int kSmemFloats = DP * QT + DP * KT + BK * DP + BK * QT;
  static constexpr int kSmemBytes = kSmemFloats * 4;
};

// Column n of a thread's score (or output) tile: groups of 4 columns at
// tx*4, strided by 32, so 8 threads cover 32 consecutive columns.
__device__ __forceinline__ int col_of(int n, int tx) {
  return (n / 4) * 32 + tx * 4 + (n % 4);
}

template <typename T, int DP, int RQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
                 int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 float scale_log2, int causal) {
  using C = Tile<DP, RQ, BK>;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DP][QT]: Q^T
  float* Kt = Qt + DP * C::QT;                  // [DP][KT]: K^T
  float* Vs = Kt + DP * C::KT;                  // [BK][DP]: V
  float* Pt = Vs + BK * DP;                     // [BK][QT]: P^T

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column group
  const int ty = tid >> 3;  // row group: rows ty*RQ .. ty*RQ+RQ-1
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // bottom-up: under a causal mask the last query tiles see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int off = Sk - Sq;  // bottom-right causal alignment
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < C::BQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.f;
    if (q0 + r < Sq && d < D) x = to_float(qp[(long long)(q0 + r) * q_ss + d]);
    Qt[d * C::QT + r] = x;
  }

  float m[RQ], l[RQ], acc[RQ][C::NO];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < C::NO; ++n) acc[i][n] = 0.f;
  }

  // keys past the last one the tile's bottom row can see add nothing
  const int kend = causal ? min(Sk, q0 + C::BQ + off) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int c = idx / DP, d = idx % DP;
      const int key = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (key < Sk && d < D) {
        kx = to_float(kp[(long long)key * k_ss + d]);
        vx = to_float(vp[(long long)key * v_ss + d]);
      }
      Kt[d * C::KT + c] = kx;
      Vs[c * DP + d] = vx;
    }
    __syncthreads();

    // scores: s[i][n] = q[row i] . k[col n]
    float s[RQ][C::NS];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int n = 0; n < C::NS; ++n) s[i][n] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RQ], ka[C::NS];
      lds<RQ>(Qt + d * C::QT + ty * RQ, qa);
#pragma unroll
      for (int g = 0; g < C::NS / 4; ++g)
        lds<4>(Kt + d * C::KT + g * 32 + tx * 4, ka + 4 * g);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int n = 0; n < C::NS; ++n) s[i][n] = fmaf(qa[i], ka[n], s[i][n]);
    }

    // mask, scale (base-2 exponent) and fold the tile into the online
    // softmax; the 8 threads of a row group are 8 consecutive lanes
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        const int key = k0 + col_of(n, tx);
        const bool vis = key < Sk && (!causal || key <= row + off);
        s[i][n] = vis ? s[i][n] * scale_log2 : kNeg;
        mx = fmaxf(mx, s[i][n]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        s[i][n] = exp2f(s[i][n] - m_new);
        sum += s[i][n];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < C::NO; ++n) acc[i][n] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      float col[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) col[i] = s[i][n];
      sts<RQ>(Pt + col_of(n, tx) * C::QT + ty * RQ, col);
    }
    __syncthreads();

    // acc[i][n] += sum_c p[row i][c] * v[c][col n]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[RQ], va[C::NO];
      lds<RQ>(Pt + c * C::QT + ty * RQ, pa);
#pragma unroll
      for (int g = 0; g < C::NO / 4; ++g)
        lds<4>(Vs + c * DP + g * 32 + tx * 4, va + 4 * g);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int n = 0; n < C::NO; ++n)
          acc[i][n] = fmaf(pa[i], va[n], acc[i][n]);
    }
  }

  T* op = out + ((long long)b * H + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      const int d = col_of(n, tx);
      if (d < D) store_as(op + (long long)row * D + d, acc[i][n] / den);
    }
  }
}

template <typename T, int DP, int RQ, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Sq, int Sk, int D, const long long* st,
           float sm_scale, int causal, cudaStream_t stream) {
  using C = Tile<DP, RQ, BK>;
  auto kern = flash_fwd_kernel<T, DP, RQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Sq, Sk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      sm_scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Sq, int Sk, int D, const long long* st,
             float sm_scale, int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32, 4, 64>(q, k, v, out, B, H, Sq, Sk, D, st, sm_scale,
                                causal, stream);
  if (D <= 64)
    return launch<T, 64, 4, 64>(q, k, v, out, B, H, Sq, Sk, D, st, sm_scale,
                                causal, stream);
  if (D <= 128)
    return launch<T, 128, 4, 32>(q, k, v, out, B, H, Sq, Sk, D, st,
                                 sm_scale, causal, stream);
  return launch<T, 256, 2, 32>(q, k, v, out, B, H, Sq, Sk, D, st, sm_scale,
                               causal, stream);
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16
// (q, k, v and out alike). strides: the (b, h, s) element strides of q,
// then k, then v; D is contiguous in all three. out is contiguous
// (B, H, Sq, D). Launches on `stream` and does not synchronize. Returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* out, int dtype,
                                        int B, int H, int Sq, int Sk, int D,
                                        const long long* strides,
                                        float sm_scale, int causal,
                                        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 ||
      B > 65535 || H > 65535 || (causal && Sq > Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, H, Sq, Sk, D, strides, sm_scale,
                           causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, Sq, Sk, D, strides,
                                   sm_scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
