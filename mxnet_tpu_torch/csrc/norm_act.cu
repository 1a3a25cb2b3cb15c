// Fused LayerNorm -> activation (K3) over the last axis of a (rows, C)
// view.
//
// Replaces the TPU kernel `_ln_act_kernel`, launched by `_pallas_norm_act`
// (mxnet_tpu/kernels/norm_act.py:45-87), which `_fused_norm_act(impl=
// "pallas")` reaches when the fusion pass (mxnet_tpu/analysis/fusion.py:
// 266-297) folds a `layer_norm` and the activation it feeds into one op.
//
// What it computes, per row, in fp32 whatever the input type:
//   mean = sum(x) / C;  var = sum((x - mean)^2) / C   (population, two-pass)
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta
//   out = act(y), cast to the input's type (round to nearest even)
// with act one of relu, sigmoid, tanh, softrelu (softplus), softsign,
// leaky (x or slope*x), elu (slope*expm1), selu, gelu (the erf form) and
// rrelu (eval mode: x or slope*x with slope the bounds' midpoint) — every
// activation form `FUSABLE_ACTS` (norm_act.py:31-36) lets the pass absorb.
// x, gamma, beta and out are all float32 or all bfloat16; rows may be any
// count (the ragged end is masked here, no padding copy).
//
// Bound: each input element is read once and each output element written
// once (gamma and beta are C values, read per row from L2/L1), about
// 2*rows*C*sizeof(T) bytes for ~12 flops per element: memory-bound at
// 3.35 TB/s (H100 SXM). At the largest launch of the wav2vec2 path
// (255,992 x 512 fp32) that is 1.049 GB, a 0.313 ms bound.
//
// Design: the TPU kernel kept a (128, C) tile in VMEM per grid step and
// padded the rows to a multiple of 128 first. A Hopper block runs in no
// order and keeps its data in registers, so:
//   - C <= 1024: one warp per row, 8 rows per 256-thread block. The row
//     sits in registers, up to 32 values per lane, loaded as 16-byte
//     float4 (8 bytes for bfloat16) when C % 4 == 0 and the pointers are
//     aligned, else as scalars; neighbouring lanes read neighbouring
//     addresses. The two sums are warp shuffles, no shared memory.
//   - 1024 < C <= 8192 (kMaxC): one 256-thread block per row, up to 32
//     values per thread, the sums reduced through shared memory. Wider
//     rows go to the torch replay (the cost model's `norm_width` reason).
//   - the variance comes from the registers in a second pass, as
//     jnp.var computes it, not from E[x^2] - E[x]^2.
//   - rows past the end return at once (per warp or per block), so any
//     row count launches without a padding copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kMaxC = 8192;
constexpr float kSeluAlpha = 1.6732632423543772f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kSqrtHalf = 0.70710678118654752f;

enum Act {
  kRelu = 0, kSigmoid = 1, kTanh = 2, kSoftrelu = 3, kSoftsign = 4,
  kLeaky = 5, kElu = 6, kSelu = 7, kGelu = 8, kRrelu = 9
};

__device__ __forceinline__ float activate(float y, int act, float slope) {
  switch (act) {
    case kRelu: return fmaxf(y, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-y));
    case kTanh: return tanhf(y);
    case kSoftrelu: return fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
    case kSoftsign: return y / (1.f + fabsf(y));
    case kLeaky:
    case kRrelu: return y > 0.f ? y : slope * y;
    case kElu: return y > 0.f ? y : slope * expm1f(y);
    case kSelu: return kSeluScale * (y > 0.f ? y : kSeluAlpha * expm1f(y));
    case kGelu: return 0.5f * y * (1.f + erff(y * kSqrtHalf));
  }
  return y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// four consecutive elements at p (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the THREADS threads that share one row
template <int THREADS>
__device__ __forceinline__ float row_sum(float v, float* smem) {
  v = warp_sum(v);
  if (THREADS == 32) return v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // smem may still hold the previous sum's partials
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  return warp_sum(lane < THREADS / 32 ? smem[lane] : 0.f);
}

// THREADS threads per row (32: a warp, blockDim (32, 8); 256: the block,
// blockDim (256, 1)); each holds up to NPER values of its row, in chunks
// of VEC consecutive elements: chunk j of thread t starts at element
// (j * THREADS + t) * VEC.
template <typename T, int THREADS, int NPER, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
norm_act_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ out,
                long long rows, int C, float eps, int act, float slope) {
  constexpr int kChunks = NPER / VEC;
  __shared__ float smem[kBlockThreads / 32];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;  // a whole warp (THREADS 32) or block leaves
  const int t = threadIdx.x;
  const T* xr = x + row * C;
  T* orow = out + row * C;

  float v[NPER];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int e = (j * THREADS + t) * VEC;
    if constexpr (VEC == 4) {
      if (e < C) {
        load4(xr + e, v + 4 * j);
      } else {
        v[4 * j] = v[4 * j + 1] = v[4 * j + 2] = v[4 * j + 3] = 0.f;
      }
    } else {
      v[j] = e < C ? to_f(xr[e]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) s += v[VEC * j + u];
  }
  const float mean = row_sum<THREADS>(s, smem) / C;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int e = (j * THREADS + t) * VEC;
    if (e < C) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const float d = v[VEC * j + u] - mean;
        ss += d * d;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<THREADS>(ss, smem) / C + eps);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int e = (j * THREADS + t) * VEC;
    if (e >= C) continue;
    float g[VEC], b[VEC], y[VEC];
    if constexpr (VEC == 4) {
      load4(gamma + e, g);
      load4(beta + e, b);
    } else {
      g[0] = to_f(gamma[e]);
      b[0] = to_f(beta[e]);
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      y[u] = activate((v[VEC * j + u] - mean) * rstd * g[u] + b[u], act,
                      slope);
    if constexpr (VEC == 4) {
      store4(orow + e, y);
    } else {
      orow[e] = from_f<T>(y[0]);
    }
  }
}

template <typename T, int THREADS, int NPER, int VEC>
int launch(const void* x, const void* g, const void* b, void* out,
           long long rows, int C, float eps, int act, float slope,
           cudaStream_t stream) {
  const int rows_per_block = kBlockThreads / THREADS;
  const dim3 block(THREADS, rows_per_block);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  norm_act_kernel<T, THREADS, NPER, VEC><<<(unsigned)blocks, block, 0,
                                           stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(out), rows, C, eps, act,
      slope);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dispatch_vec(const void* x, const void* g, const void* b, void* out,
                 long long rows, int C, float eps, int act, float slope,
                 cudaStream_t st) {
  if (C <= 128)
    return launch<T, 32, 4, VEC>(x, g, b, out, rows, C, eps, act, slope, st);
  if (C <= 256)
    return launch<T, 32, 8, VEC>(x, g, b, out, rows, C, eps, act, slope, st);
  if (C <= 512)
    return launch<T, 32, 16, VEC>(x, g, b, out, rows, C, eps, act, slope, st);
  if (C <= 1024)
    return launch<T, 32, 32, VEC>(x, g, b, out, rows, C, eps, act, slope, st);
  return launch<T, kBlockThreads, 32, VEC>(x, g, b, out, rows, C, eps, act,
                                           slope, st);
}

template <typename T>
int dispatch(const void* x, const void* g, const void* b, void* out,
             long long rows, int C, float eps, int act, float slope,
             cudaStream_t st) {
  const unsigned align = 4 * sizeof(T);
  const bool vec = C % 4 == 0 && (size_t)x % align == 0 &&
                   (size_t)g % align == 0 && (size_t)b % align == 0 &&
                   (size_t)out % align == 0;
  if (vec)
    return dispatch_vec<T, 4>(x, g, b, out, rows, C, eps, act, slope, st);
  return dispatch_vec<T, 1>(x, g, b, out, rows, C, eps, act, slope, st);
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16 (x,
// gamma, beta and out alike). x and out are contiguous (rows, C), gamma and
// beta contiguous (C,). act is an Act code; slope is leaky's or elu's slope,
// or rrelu's midpoint. Launches on `stream` and does not synchronize.
// Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int mxtt_norm_act(const void* x, const void* gamma,
                             const void* beta, void* out, int dtype,
                             long long rows, int C, float eps, int act,
                             float slope, void* stream) {
  if (rows <= 0 || C <= 0 || C > kMaxC || act < kRelu || act > kRrelu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, gamma, beta, out, rows, C, eps, act, slope, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, gamma, beta, out, rows, C, eps, act,
                                   slope, st);
  return (int)cudaErrorInvalidValue;
}
