// int8 x int8 -> int32 convolution (N2), NCHW data, OIHW weights.
//
// Not a TPU kernel: it replaces what XLA compiles for
// `lax.conv_general_dilated(int8, int8, preferred_element_type=int32)`
// (mxnet_tpu/ndarray/ops_quant.py:341-346, the `native` lowering of
// `_contrib_quantized_conv`, and mxnet_tpu/contrib/quantization.py:124-133,
// `QuantizedConv2D`). PyTorch has no int8 convolution on CUDA that
// accumulates in int32: `F.conv2d` refuses int8 CUDA tensors.
//
// What it computes, per group g (C, O divisible by `groups`; Cg = C/groups,
// Og = O/groups):
//   y[n, g*Og + o, ho, wo] = sum over c < Cg, r < kh, s < kw of
//       x[n, g*Cg + c, ho*sh - ph + r*dh, wo*sw - pw + s*dw] *
//       w[g*Og + o, c, r, s]
// with taps outside the image counting 0, accumulated in int32 (a sum of
// K = Cg*kh*kw products of at most 127 * 128 stays far inside int32 for
// every K below 2^17). The bias stays outside: the quantized op adds it on
// the int32 lattice.
//
// Design (simple and right first; a Hopper redesign with wgmma fed by TMA,
// NHWC and the requantize epilogue fused is later work):
//   - an implicit GEMM: rows m are output pixels (M = N*Ho*Wo), columns n
//     the group's filters (Og), the reduction k runs over (c, r, s) in the
//     weight's own OIHW order (K = Cg*kh*kw);
//   - one 128-thread block per 64 x 64 output tile of one group; per step
//     of 32 k, the block gathers its im2col tile (64 pixels x 32 k) and its
//     weight tile (64 filters x 32 k) into shared memory, with zeros for
//     padding taps, for rows or filters past the edge and for the ragged K
//     tail (the 7 x 7 stem over 3 channels has K = 147), then each warp
//     multiplies a 32 x 32 quarter with `mma.sync.m16n8k32` on int8
//     operands into int32 (2 x 4 tiles of 16 x 8);
//   - each thread gathers 16 consecutive k of one pixel with byte loads,
//     stepping (c, r, s) by increments, and a warp's 32 threads take 32
//     consecutive pixels, so each byte load of the warp is one contiguous
//     run of the image where the stride is 1;
//   - weights: each thread reads 16 consecutive k of one filter, as one
//     16-byte load when K is a multiple of 16 (`vec_b`, rows then start on
//     16-byte boundaries, which the wrapper guarantees), else bytewise;
//   - shared-memory rows are 48 bytes (32 used): the eight rows a fragment
//     load touches then fall on distinct banks.
//
// Bound at ResNet-50's batch-32 shapes: 2*M*Og*K operations at the card's
// dense int8 tensor rate, or the int8 input and weights read once and the
// int32 output written once at the memory rate, whichever is longer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // filters per block
constexpr int kBK = 32;       // reduction step
constexpr int kThreads = 128;
constexpr int kRow = 48;      // bytes per shared-memory row

struct Shape {
  int N, C, H, W, O, KH, KW, Ho, Wo, sh, sw, ph, pw, dh, dw, groups;
  int Cg, Og, K, M;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool kVecB>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ y, Shape s) {
  __shared__ __align__(16) int8_t sA[kBM * kRow];
  __shared__ __align__(16) int8_t sB[kBN * kRow];
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hw = s.Ho * s.Wo;
  const int khw = s.KH * s.KW;

  // loader roles: row lr of both tiles, k half lk
  const int lr = tid & (kBM - 1);
  const int lk = (tid >> 6) * 16;
  const int am = m0 + lr;
  const bool a_ok = am < s.M;
  int ih0 = 0, iw0 = 0;
  const int8_t* xg = x;
  if (a_ok) {
    const int img = am / hw;
    const int rem = am - img * hw;
    const int ho = rem / s.Wo;
    const int wo = rem - ho * s.Wo;
    ih0 = ho * s.sh - s.ph;
    iw0 = wo * s.sw - s.pw;
    xg = x + (static_cast<size_t>(img) * s.C +
              static_cast<size_t>(g) * s.Cg) * s.H * s.W;
  }
  const int bn = n0 + lr;
  const bool b_ok = bn < s.Og;
  const int8_t* wrow =
      w + (static_cast<size_t>(g) * s.Og + (b_ok ? bn : 0)) * s.K;

  // compute roles: warp quarter (wm, wn), fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int grp = lane >> 2, tig = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < s.K; k0 += kBK) {
    // im2col tile: 16 consecutive k of pixel am
    {
      const int k = k0 + lk;
      int c = k / khw;
      int rs = k - c * khw;
      int r = rs / s.KW;
      int q = rs - r * s.KW;
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int v = 0;
        if (a_ok && k + j < s.K) {
          const int ih = ih0 + r * s.dh;
          const int iw = iw0 + q * s.dw;
          if (ih >= 0 && ih < s.H && iw >= 0 && iw < s.W)
            v = static_cast<uint8_t>(
                xg[(static_cast<size_t>(c) * s.H + ih) * s.W + iw]);
        }
        packed[j >> 2] |= static_cast<uint32_t>(v) << ((j & 3) * 8);
        if (++q == s.KW) {
          q = 0;
          if (++r == s.KH) {
            r = 0;
            ++c;
          }
        }
      }
      *reinterpret_cast<uint4*>(&sA[lr * kRow + lk]) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    // weight tile: 16 consecutive k of filter bn
    {
      const int k = k0 + lk;
      if (kVecB) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (b_ok && k < s.K) v = *reinterpret_cast<const uint4*>(wrow + k);
        *reinterpret_cast<uint4*>(&sB[lr * kRow + lk]) = v;
      } else {
        uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int v = (b_ok && k + j < s.K)
                            ? static_cast<uint8_t>(wrow[k + j]) : 0;
          packed[j >> 2] |= static_cast<uint32_t>(v) << ((j & 3) * 8);
        }
        *reinterpret_cast<uint4*>(&sB[lr * kRow + lk]) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
    __syncthreads();
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wm + i * 16 + grp;
      a[i][0] = ld_u32(&sA[row * kRow + tig * 4]);
      a[i][1] = ld_u32(&sA[(row + 8) * kRow + tig * 4]);
      a[i][2] = ld_u32(&sA[row * kRow + 16 + tig * 4]);
      a[i][3] = ld_u32(&sA[(row + 8) * kRow + 16 + tig * 4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn + j * 8 + grp;
      b[j][0] = ld_u32(&sB[col * kRow + tig * 4]);
      b[j][1] = ld_u32(&sB[col * kRow + 16 + tig * 4]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

  // epilogue: accumulator (row, col) -> y[img, g*Og + n, ho, wo]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + grp + half * 8;
      if (m >= s.M) continue;
      const int img = m / hw;
      const int rem = m - img * hw;
      int32_t* yrow = y + static_cast<size_t>(img) * s.O * hw + rem;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + tig * 2 + e;
          if (n < s.Og)
            yrow[static_cast<size_t>(g * s.Og + n) * hw] =
                acc[i][j][half * 2 + e];
        }
      }
    }
  }
}

}  // namespace

// Launch N2 on `stream`. Returns 0, or the CUDA error of the launch.
extern "C" int mxtt_int8_conv(const int8_t* x, const int8_t* w, int32_t* y,
                              int N, int C, int H, int W, int O, int KH,
                              int KW, int Ho, int Wo, int sh, int sw, int ph,
                              int pw, int dh, int dw, int groups, int vec_b,
                              void* stream) {
  Shape s{N, C, H, W, O, KH, KW, Ho, Wo, sh, sw, ph, pw, dh, dw, groups,
          C / groups, O / groups, 0, 0};
  s.K = s.Cg * KH * KW;
  s.M = N * Ho * Wo;
  if (s.M == 0 || s.Og == 0) return 0;
  const dim3 grid((s.M + kBM - 1) / kBM, (s.Og + kBN - 1) / kBN, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_b)
    int8_conv_kernel<true><<<grid, kThreads, 0, st>>>(x, w, y, s);
  else
    int8_conv_kernel<false><<<grid, kThreads, 0, st>>>(x, w, y, s);
  return static_cast<int>(cudaGetLastError());
}
