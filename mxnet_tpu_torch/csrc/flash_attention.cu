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
// mask is aligned bottom-right, as the TPU kernel's is. The softmax is
// kept in fp32 (running max m, sum l and accumulator per row) across the
// sweep over key tiles; masked scores are -1e30, so they get exactly zero
// weight; the output is acc / max(l, 1e-30), cast to q's dtype. Inputs
// are fp32 or bf16. bf16 q, k and v at D = 64 that TMA can read in place
// (the LM's under AMP) go to csrc/flash_attention_sm90.cu instead, the
// wgmma kernel built for them; this one takes every other input
// (`_flash_route`, mxnet_tpu_torch/kernels/flash_attention.py).
//
// Products: tensor cores in 3xTF32. Both products, Q.K^T and P.V, run as
// mma.sync.m16n8k8 TF32 with fp32 accumulation. TF32 keeps 10 mantissa
// bits, so one pass would leave ~3 digits, far outside the 1e-5 the JAX
// package holds its kernel to. So each fp32 operand x is split as
// big = tf32(x) and small = tf32(x - big), both rounded to nearest, ties
// away (cvt.rna's rounding), and a.b is taken as a_small.b_big +
// a_big.b_small + a_big.b_big into fp32 accumulators. |x - big| <=
// 2^-11 |x| and small rounds that to within 2^-22 |x|; the dropped
// a_small.b_small is below 2^-22 |a.b|. So each product is within ~3 *
// 2^-22 (7e-7) of fp32's; the CPU emulation of this arithmetic in
// tests/test_torch_flash_attention.py stays within 1e-5 of the plain
// version where one pass does not. The tensor cores truncate each sum to
// the exponent of its largest term instead of rounding it, so the order
// of the sums matters too: at D <= 64 a tile's P.V is summed from zero
// and added to O in fp32 (one rounding to nearest per tile), and a
// tile's small terms of every k-step go into S before its big.big terms.
// At the training shape the first takes the largest error from 4.9e-6 to
// 2.1e-6 at no cost, the second from 3.1e-6 to 2.1e-6 for 2.5% of the
// time (tools/kernel_variants.py). bf16 inputs are exact in TF32, so for
// them Q.K^T takes one pass and P.V two (only P is split). The fp32 path
// never takes fewer than three.
//
// Layout: q, k and v are read through their (b, h, s) strides with D
// contiguous, so the model's q/k/v views of one fused qkv projection
// are read in place, without a copy. out is a fresh contiguous
// (B, H, S_q, D) tensor.
//
// Bound: at the training path's shape (B 8, H 12, S 1024, D 64, causal)
// the visible (query, key) pairs are B*H*S*(S+1)/2, each costing 2*D
// flops for q.k and 2*D for p.v: 12.9 GFLOP. As fp32 FMAs outside the
// tensor cores (67 TFLOP/s) that is 0.1925 ms; in this design's 3xTF32,
// 3 x 12.9 GFLOP at the 495 TFLOP/s of TF32 is 0.0782 ms. On the fusion
// route's (128, 1, 499, 499, 64), not causal, 8.16 GFLOP: 0.1218 ms in
// fp32 SIMT, 0.0495 ms in 3xTF32. The 100.7 MB of q, k, v and out take
// 0.030 ms at 3.35 TB/s, so both shapes are bound by operations. What
// the design does about that bound:
//   - a block owns one (b, h, tile of query rows), one warp per 16 rows,
//     and sweeps the key tiles in a loop, keeping m, l and the output
//     accumulator in registers (the TPU grid's sequential key axis with
//     scratch carried across grid steps becomes that loop). At D <= 64 a
//     block has 8 warps (128 rows), above it 4 (64 rows);
//   - at D <= 64 each warp's Q fragments, split into big and small, stay
//     in registers for the whole sweep (64 registers at D = 64); at
//     D = 128 and 256 Q stays in shared memory as fp32 and is split as
//     it is loaded;
//   - K and V tiles arrive through a two-stage cp.async ring: tile k+1
//     is in flight while tile k is multiplied, with one
//     cp.async.wait_group and one __syncthreads per tile. In fp32 the
//     block then splits the landed tile once (big in place, small into a
//     third buffer), behind a second __syncthreads, so no warp splits a
//     K or V value (splitting every fragment in every warp, as a first
//     version did, made the splits most of the kernel's instructions);
//   - the k index of both products is numbered within each group of 8 so
//     that k = t is element 2t and k = t + 4 element 2t + 1 (of D for
//     Q.K^T, of the tile's keys for P.V), with g = lane/4, t = lane%4.
//     Then a thread's two B values of a k-step are neighbours (one 64-bit
//     load), and the A fragment of P.V, (g, k=t), (g+8, t), (g, t+4),
//     (g+8, t+4), is S's C fragment (g, 2t), (g+8, 2t), (g, 2t+1),
//     (g+8, 2t+1) as it stands: P never leaves registers, no shuffle and
//     no barrier. Output columns d = 16 (n/2) + 2c + n%2 of n-tile n make
//     V's B values of n-tiles 2m and 2m+1 neighbours too. K rows are
//     padded by 8 floats and V rows by 4 (8 bf16 each), so those 64-bit
//     loads are free of bank conflicts;
//   - copies are 16 bytes (cp.async.cg) where every K/V row start and the
//     row length are 16-byte aligned; else 4 bytes (cp.async.ca) where
//     they are 4-byte aligned (fp32 always is); else, for bf16 rows of
//     odd length or odd strides, element loads into shared memory. The
//     wrapper picks the width from the dtype, D, the base pointers and
//     the strides, and passes it in; keys past S_k are zero-filled by the
//     copy (src-size 0), D is padded to DP with zeros in shared memory;
//   - BK (keys per tile) is 64 at D <= 64 and 16 above. Shared memory at
//     D = 64 is 107.5 KB in fp32 (two stages and the small halves; 36.9
//     KB in bf16), and the fp32 kernel takes about 240 registers a thread,
//     so 8 warps fit on an SM: one block of 8 warps, 1% (training) and 5%
//     (route) faster than two blocks of 4, since the split pass and the
//     K/V tiles serve twice the rows; BK = 32 was 12% and 10% slower.
//     D = 128: 86.3 KB
//     in fp32, 2 blocks of 4 warps; D = 256: 168.2 KB, 1 (opted into above
//     48 KB with cudaFuncSetAttribute);
//   - when causal, the key loop stops at the last tile the query tile can
//     see (the TPU kernel's skip of tiles above the diagonal), a warp
//     skips a tile none of its rows can see, the mask is computed only on
//     tiles that cross the diagonal or S_k, and blocks take query tiles
//     from the bottom up, so the longest tiles start first;
//   - the softmax works in base 2 with scale*log2(e) folded into one
//     multiply; a thread's share of l is summed across its quad once, at
//     the end.
// This design reaches about a fifth of its 3xTF32 bound (PERF.md).
//
// The gradient is not a kernel: the JAX package's backward
// (`_flash_bwd`, flash_attention.py:206-245) is an XLA q-chunk recompute,
// not Pallas, so the port's backward is the same recompute in PyTorch
// (`_flash_bwd` in mxnet_tpu_torch/kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kStages = 2;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding of finite values in two integer
// instructions (cvt.rna also screens NaN and infinity, which stay
// non-finite here too); 2-3% faster end to end (tools/kernel_variants.py)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a . b on the tensor cores: m16n8k8, TF32 operands, fp32 sums
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: small.big + big.small + big.big, small terms first
__device__ __forceinline__ void mma3(float* c, const uint32_t* ab,
                                     const uint32_t* as, uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// DP: D padded to 32, 64, 128 or 256; BK: keys per tile.
template <typename T, int DP, int BK>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // warps of 16 query rows: 8 at D <= 64 (one block of 256 threads per
  // SM, the split pass and K/V tiles shared by 128 rows), 4 above, where
  // 128 rows of Q would not fit beside the tiles in shared memory
  static constexpr int kWarps = DP <= 64 ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kMinBlocks = DP <= 64 ? 1 : 2;
  static constexpr int BQ = kWarps * 16;  // query rows per block
  // row strides (elements) of the K and V tiles: 16-byte rows for the
  // copies, and conflict-free 64-bit fragment loads (see the kernel)
  static constexpr int KS = DP + 8;
  static constexpr int VS = DP + (kF32 ? 4 : 8);
  static constexpr int QS = DP + 8;  // row stride of the fp32 Q tile
  static constexpr bool kQInRegs = DP <= 64;
  static constexpr int kStageElems = BK * (KS + VS);  // one K and one V tile
  // fp32: the ring's stages, then the small halves of the tile in use
  static constexpr int kBuffers = kStages + (kF32 ? 1 : 0);
  static constexpr int kSmemBytes = kBuffers * kStageElems * (int)sizeof(T) +
                                    (kQInRegs ? 0 : BQ * QS * 4);
};

// Copy keys [k0, k0 + BK) of K and V into one stage of the ring, `width`
// bytes per copy (16, 4, or the element size: plain loads). Keys past S_k
// are zero-filled; columns D..DP stay as zeroed at the start.
template <typename T, int DP, int BK>
__device__ __forceinline__ void load_tile(T* Ks, T* Vs, const T* kp,
                                          const T* vp, long long k_ss,
                                          long long v_ss, int k0, int Sk,
                                          int D, int width, int tid) {
  using C = Tile<T, DP, BK>;
  if (width == 16 || width == 4) {
    const int per = width / (int)sizeof(T);  // elements per copy
    const int cpr = D / per;                 // copies per row
    for (int i = tid; i < BK * cpr; i += C::kThreads) {
      const int r = i / cpr, c = (i - r * cpr) * per;
      const bool ok = k0 + r < Sk;
      const long long row = ok ? k0 + r : 0;  // a valid address either way
      if (width == 16) {
        cp_async16(Ks + r * C::KS + c, kp + row * k_ss + c, ok);
        cp_async16(Vs + r * C::VS + c, vp + row * v_ss + c, ok);
      } else {
        cp_async4(Ks + r * C::KS + c, kp + row * k_ss + c, ok);
        cp_async4(Vs + r * C::VS + c, vp + row * v_ss + c, ok);
      }
    }
  } else {
    for (int i = tid; i < BK * D; i += C::kThreads) {
      const int r = i / D, c = i - r * D;
      const bool ok = k0 + r < Sk;
      const long long row = k0 + r;
      Ks[r * C::KS + c] = ok ? kp[row * k_ss + c] : zero_of<T>();
      Vs[r * C::VS + c] = ok ? vp[row * v_ss + c] : zero_of<T>();
    }
  }
}

// fp32: split the landed tile once for the whole block: big = tf32(x) in
// place, small = tf32(x - big) into the small buffer, same layout
template <int DP, int BK>
__device__ __forceinline__ void split_tile(float* KV, float* small, int tid) {
  using C = Tile<float, DP, BK>;
  constexpr int RQ = DP / 4;  // float4s per row
  for (int i = tid; i < 2 * BK * RQ; i += C::kThreads) {
    const int r = i / RQ, c = (i - r * RQ) * 4;  // K rows, then V rows
    const int off = r < BK ? r * C::KS + c : BK * C::KS + (r - BK) * C::VS + c;
    const float4 x = *reinterpret_cast<const float4*>(KV + off);
    uint32_t b[4], s4[4];
    split(x.x, b[0], s4[0]);
    split(x.y, b[1], s4[1]);
    split(x.z, b[2], s4[2]);
    split(x.w, b[3], s4[3]);
    *reinterpret_cast<uint4*>(KV + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) =
        make_uint4(s4[0], s4[1], s4[2], s4[3]);
  }
}

template <typename T>
__device__ __forceinline__ float2 ld2(const T* p);
template <>
__device__ __forceinline__ float2 ld2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 ld2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ uint32_t bits(float x) {
  return __float_as_uint(x);
}

// acc += P . V for one warp and tile: P from S's C fragments (keys 2t and
// 2t + 1 of each 8), V's B values of n-tiles n and n + 1 as neighbours
template <typename T, int DP, int BK>
__device__ __forceinline__ void pv_product(float (&acc)[DP / 8][4],
                                           const float (&s)[BK / 8][4],
                                           const T* Vs, const T* Vl, int t,
                                           int g) {
  using C = Tile<T, DP, BK>;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t pb[4], ps[4];
    split(s[j][0], pb[0], ps[0]);
    split(s[j][2], pb[1], ps[1]);
    split(s[j][1], pb[2], ps[2]);
    split(s[j][3], pb[3], ps[3]);
    const int at = (j * 8 + 2 * t) * C::VS + 2 * g;
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      const float2 v0 = ld2(Vs + at + n * 8);          // key 2t
      const float2 v1 = ld2(Vs + at + C::VS + n * 8);  // key 2t + 1
      if constexpr (C::kF32) {
        const float2 l0 = ld2(Vl + at + n * 8);
        const float2 l1 = ld2(Vl + at + C::VS + n * 8);
        mma3(acc[n], pb, ps, bits(v0.x), bits(v1.x), bits(l0.x),
             bits(l1.x));
        mma3(acc[n + 1], pb, ps, bits(v0.y), bits(v1.y), bits(l0.y),
             bits(l1.y));
      } else {
        mma(acc[n], ps, bits(v0.x), bits(v1.x));
        mma(acc[n + 1], ps, bits(v0.y), bits(v1.y));
        mma(acc[n], pb, bits(v0.x), bits(v1.x));
        mma(acc[n + 1], pb, bits(v0.y), bits(v1.y));
      }
    }
  }
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(Tile<T, DP, BK>::kThreads,
                                  Tile<T, DP, BK>::kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
                 int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 float scale_log2, int causal, int width) {
  using C = Tile<T, DP, BK>;
  constexpr bool kF32 = C::kF32;
  constexpr int NK = DP / 8;  // k-steps of Q.K^T over D
  constexpr int NS = BK / 8;  // n-tiles of S, k-steps of P.V
  constexpr int NO = DP / 8;  // n-tiles of the output
  constexpr bool kTileAcc = DP <= 64;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // [stage][K tile | V tile]
  T* small = ring + kStages * C::kStageElems;  // fp32: the small halves
  float* Qs = reinterpret_cast<float*>(ring + C::kBuffers * C::kStageElems);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // bottom-up: under a causal mask the last query tiles see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int off = Sk - Sq;  // bottom-right causal alignment
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  // keys past the last one the tile's bottom row can see add nothing
  const int kend = causal ? min(Sk, q0 + C::BQ + off) : Sk;
  const int ntiles = (kend + BK - 1) / BK;
  if (D < DP) {  // the padding columns of every stage, once
    const int w = DP - D;
    for (int i = tid; i < kStages * BK * w; i += C::kThreads) {
      const int r = i / w, c = D + (i - r * w);
      T* st = ring + (r / BK) * C::kStageElems;
      st[(r % BK) * C::KS + c] = zero_of<T>();
      st[BK * C::KS + (r % BK) * C::VS + c] = zero_of<T>();
    }
  }
  load_tile<T, DP, BK>(ring, ring + BK * C::KS, kp, vp, k_ss, v_ss, 0, Sk,
                       D, width, tid);
  cp_async_commit();

  // The k index of both products is permuted within each group of 8:
  // k = t is element 2t and k = t + 4 element 2t + 1 (of D for Q.K^T, of
  // the tile's keys for P.V). So a thread's two B values (and Q's A
  // values) of a k-step are neighbours, one 64-bit load, and P's A
  // fragment is S's C fragment as it stands. The output columns of n-tile
  // n are d = 16 (n/2) + 2c + n%2, so V's B values of n-tiles 2m and
  // 2m + 1 are neighbours too.
  const int wr = warp * 16 + g;  // this thread's rows: wr and wr + 8
  uint32_t qb[C::kQInRegs ? NK : 1][4], qsm[C::kQInRegs && kF32 ? NK : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + wr + (e & 1) * 8;
        const int col = kk * 8 + 2 * t + (e >> 1);
        const float x = row < Sq && col < D
                            ? to_float(qp[(long long)row * q_ss + col])
                            : 0.f;
        if constexpr (kF32)
          split(x, qb[kk][e], qsm[kk][e]);
        else
          qb[kk][e] = bits(x);  // bf16 is exact in TF32
      }
  } else {
    for (int i = tid; i < C::BQ * DP; i += C::kThreads) {
      const int r = i / DP, d = i % DP;
      Qs[r * C::QS + d] = q0 + r < Sq && d < D
                              ? to_float(qp[(long long)(q0 + r) * q_ss + d])
                              : 0.f;
    }
  }

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad last
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    cp_async_wait_all();  // this thread's copies of tile it have landed
    __syncthreads();      // everyone's have; tile it-1 is consumed
    if (it + 1 < ntiles) {
      T* nxt = ring + ((it + 1) % kStages) * C::kStageElems;
      load_tile<T, DP, BK>(nxt, nxt + BK * C::KS, kp, vp, k_ss, v_ss,
                           k0 + BK, Sk, D, width, tid);
      cp_async_commit();
    }
    T* Ks = ring + (it % kStages) * C::kStageElems;
    if constexpr (kF32) {
      split_tile<DP, BK>(reinterpret_cast<float*>(Ks),
                         reinterpret_cast<float*>(small), tid);
      __syncthreads();
    }
    // none of the warp's rows sees a key of this tile
    if (causal && k0 > q0 + warp * 16 + 15 + off) continue;
    const T* Vs = Ks + BK * C::KS;
    const T* Kl = small;  // fp32 only: the small halves, same layout
    const T* Vl = small + BK * C::KS;

    // S = Q . K^T for the warp's 16 rows and the tile's BK keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // fp32: first every small term (a_small.b_big + a_big.b_small) of
    // every k-step, while the sums are small, then the big.big terms:
    // the tensor cores truncate each sum to the largest term's exponent,
    // so the large terms are added in as few steps as possible
    auto qk_step = [&](int pass, int kk) {
      uint32_t ab[4], as[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qb[kk][e];
          if constexpr (kF32) as[e] = qsm[kk][e];
        }
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 x = *reinterpret_cast<const float2*>(
              Qs + (wr + hf * 8) * C::QS + kk * 8 + 2 * t);
          if constexpr (kF32) {
            split(x.x, ab[hf], as[hf]);
            split(x.y, ab[hf + 2], as[hf + 2]);
          } else {
            ab[hf] = bits(x.x);
            ab[hf + 2] = bits(x.y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int at = (j * 8 + g) * C::KS + kk * 8 + 2 * t;
        const float2 kb = ld2(Ks + at);
        if (kF32 && pass == 0) {
          const float2 kl = ld2(Kl + at);
          mma(s[j], as, bits(kb.x), bits(kb.y));
          mma(s[j], ab, bits(kl.x), bits(kl.y));
        } else {
          mma(s[j], ab, bits(kb.x), bits(kb.y));
        }
      }
    };
    if constexpr (C::kQInRegs) {  // Q's registers need constant indices
#pragma unroll
      for (int pass = 0; pass < (kF32 ? 2 : 1); ++pass)
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) qk_step(pass, kk);
    } else {  // a full unroll at D = 256 spills
      for (int pass = 0; pass < (kF32 ? 2 : 1); ++pass)
#pragma unroll 2
        for (int kk = 0; kk < NK; ++kk) qk_step(pass, kk);
    }

    // mask (only on tiles that cross the diagonal or S_k), scale in base 2,
    // and fold the tile into the online softmax; a row's values sit in
    // the four lanes of a quad
    float alphas[2];
    const bool masked = k0 + BK > Sk ||
                        (causal && k0 + BK - 1 > q0 + warp * 16 + off);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + wr + hf * 8;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][hf * 2 + e] * scale_log2;
          if (masked) {
            const int key = k0 + j * 8 + 2 * t + e;
            if (key >= Sk || (causal && key > row + off)) x = kNeg;
          }
          s[j][hf * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float alpha = exp2f(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][hf * 2 + e] - m_new);
          s[j][hf * 2 + e] = p;
          sum += p;
        }
      l[hf] = l[hf] * alpha + sum;
      m[hf] = m_new;
      alphas[hf] = alpha;
    }

    // O = alpha O + P . V. At D <= 64 the tile's P . V is summed from zero
    // and added to O in fp32 (one rounding to nearest per tile), so the
    // tensor cores' truncation acts on one tile's sum, not on all of O
    if constexpr (kTileAcc) {
      float pv[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
      pv_product<T, DP, BK>(pv, s, Vs, Vl, t, g);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = fmaf(o[n][e], alphas[e >> 1], pv[n][e]);
    } else {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alphas[e >> 1];
      pv_product<T, DP, BK>(o, s, Vs, Vl, t, g);
    }
  }

  T* op = out + ((long long)b * H + h) * Sq * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + wr + hf * 8;
    if (row >= Sq) continue;
    const float den = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = (n / 2) * 16 + 4 * t + 2 * e + (n & 1);
        if (d < D)
          store_as(op + (long long)row * D + d, o[n][hf * 2 + e] / den);
      }
  }
}

template <typename T, int DP, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Sq, int Sk, int D, const long long* st,
           float sm_scale, int causal, int width, cudaStream_t stream) {
  using C = Tile<T, DP, BK>;
  auto kern = flash_fwd_kernel<T, DP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Sq, Sk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      sm_scale * kLog2e, causal, width);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Sq, int Sk, int D, const long long* st,
             float sm_scale, int causal, int width, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32, 64>(q, k, v, out, B, H, Sq, Sk, D, st, sm_scale,
                             causal, width, stream);
  if (D <= 64)
    return launch<T, 64, 64>(q, k, v, out, B, H, Sq, Sk, D, st, sm_scale,
                             causal, width, stream);
  if (D <= 128)
    return launch<T, 128, 16>(q, k, v, out, B, H, Sq, Sk, D, st, sm_scale,
                              causal, width, stream);
  return launch<T, 256, 16>(q, k, v, out, B, H, Sq, Sk, D, st, sm_scale,
                            causal, width, stream);
}

// Whether every K and V row start, and the row length, allow copies of
// `width` bytes (the element size always does).
bool copies_fit(const void* k, const void* v, int D, int elem,
                const long long* st, int width) {
  if (width == elem) return true;
  if (width != 16 && width != 4) return false;
  if (((long long)D * elem) % width) return false;
  if ((uintptr_t)k % width || (uintptr_t)v % width) return false;
  for (int i = 3; i < 9; ++i)
    if ((st[i] * elem) % width) return false;
  return true;
}

}  // namespace

// C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16
// (q, k, v and out alike). strides: the (b, h, s) element strides of q,
// then k, then v; D is contiguous in all three. out is contiguous
// (B, H, Sq, D). width: the bytes per copy of a K/V tile into shared
// memory, 16, 4 or the element size, which the rows' alignment must
// allow. Launches on `stream` and does not synchronize. Returns
// cudaGetLastError() after the launch: 0 on success.
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* out, int dtype,
                                        int B, int H, int Sq, int Sk, int D,
                                        const long long* strides,
                                        float sm_scale, int causal,
                                        void* stream, int width) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 ||
      B > 65535 || H > 65535 || (causal && Sq > Sk) || (dtype != 0 &&
      dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (!copies_fit(k, v, D, elem, strides, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, H, Sq, Sk, D, strides, sm_scale,
                           causal, width, st);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, Sq, Sk, D, strides,
                                 sm_scale, causal, width, st);
}
