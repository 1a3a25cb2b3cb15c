// Flash-attention forward (K1) in bfloat16 at head width 64, for Hopper:
// wgmma fed by TMA from a producer warp, P kept to fp32 accuracy.
//
// Replaces, for bf16 q, k and v with D = 64, the TPU kernel `_fa_kernel`
// (launched by `_pallas_forward`), mxnet_tpu/kernels/flash_attention.py:
// 48-134, on the path of `TransformerLM` under bf16 AMP. Every other K1
// input (fp32, other head widths, rows TMA cannot read) stays with
// csrc/flash_attention.cu; the wrapper picks the kernel from dtypes,
// shapes, strides and pointers (`_flash_route`,
// mxnet_tpu_torch/kernels/flash_attention.py).
//
// What it computes: `_fa_kernel`'s arithmetic. For each (b, h) and query
// row i, out[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h,j,:] * sm_scale) .
// v[b,h,:,:] over keys j < S_k and, when causal, j <= i + (S_k - S_q)
// (bottom-right alignment). The TPU kernel casts q, k and v to fp32, so
// its P stays fp32 in P.V. Here Q.K^T is exact in bf16 products with fp32
// sums; the running max m, sum l and the output accumulator O stay in
// fp32 across the sweep over key tiles, the softmax in base 2 with
// sm_scale * log2(e) folded into one fused multiply-add with the max. A
// masked key's weight is exactly 0, as the TPU kernel's -1e30 makes it.
// P is split in two bf16 parts: P_hi, p cut to bf16 (its high 16 bits),
// and P_lo = bf16(p - P_hi), which together hold p to 2^-16 of itself,
// and O += P.V is taken as P_lo.V and then P_hi.V: the tensor cores
// truncate each sum to the exponent of its largest term, so the small
// terms go in first. The output is O / max(l, 1e-30), rounded once to
// bf16. tests/test_torch_flash_attention.py emulates this arithmetic on
// the CPU against the TPU kernel (interpret mode) and the plain version;
// chip_smoke.py holds the kernel against the plain version in fp32,
// rounded once, within two bf16 ulps. One bf16 pass of P would not hold
// that bound (the emulation shows it).
//
// Bounds at the LM's training shape (B 8, H 12, S 1024, D 64, causal):
// the function moves 50.3 MB (q, k, v read once, out written once), 0.0150
// ms at 3.35 TB/s; its visible (query, key) pairs cost 2*D flops for q.k
// and 2*D for p.v, and the two-pass P.V doubles the second: 19.3 GFLOP,
// 0.0195 ms at 989 TFLOP/s in bf16. So the design is bound by its
// operations, and what it does about them:
//   - the products run as wgmma, the only instruction that reaches the
//     bf16 rate: S = Q.K^T as m64n128k16 with both operands in shared
//     memory (K-major, 128-byte swizzle), O += P.V as m64n64k16 with P in
//     registers, where S's accumulator fragments sit exactly where P's A
//     fragments must (each pair of neighbouring fp32 values becomes one
//     bf16x2 register), and V read as it lies, keys by D, through the
//     transpose bit of the 16-bit wgmma: no transposed copy, and no K or
//     V element converted by any thread;
//   - TMA copies the tiles: one producer warp (its warpgroup gives back
//     registers with setmaxnreg.dec) loads Q into two buffers and keeps a
//     ring of kStages K and V tiles of 128 keys in flight on full and empty
//     mbarriers; a K tile is released once Q.K^T has read it, its V a
//     window later, and no __syncthreads sits in the key loop. The tensor
//     maps span the (D, S, H, B) geometry with the tensors' own byte
//     strides, so the model's q, k and v views of one fused projection
//     are read in place, and rows past S_q or S_k arrive as zeros;
//   - two consumer warpgroups of 64 query rows each (setmaxnreg.inc to
//     240 registers) take turns on two named barriers to issue their
//     products, so one's softmax runs under the other's wgmma (FA3's
//     ping-pong). Inside a warpgroup the next tile's Q.K^T is issued
//     together with this tile's P.V, so the softmax of one tile also runs
//     under the tensor cores' work on the previous one;
//   - a persistent grid, one block per SM: each block walks work items
//     (a (b, h) and a tile of 128 query rows), longest causal tiles first,
//     dealt in a snake order that keeps every block's share of tiles
//     within about one tile of the mean; the next item's Q and first K/V
//     tiles load while the current item finishes;
//   - causal: an item stops at the last key tile its bottom row can see,
//     a warpgroup skips the tiles none of its rows can see and masks only
//     tiles that cross its diagonal or S_k;
//   - the epilogue divides by l and stores bf16 pairs straight into the
//     fresh contiguous (B, H, S_q, D) output.
// At the training shape it reaches about a third of the operations bound;
// tools/kernel_variants.py times the design with one choice undone at a
// time, which shows where the rest goes (PERF.md). chip_smoke.py
// (phase 23) and tools/compare_kernels.py time it beside the mma.sync
// kernel at the same shape; PERF.md keeps the numbers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kD = 64;                 // head width, one 128-byte row
constexpr int kBM = 64;                // query rows per consumer warpgroup
constexpr int kConsumers = 2;          // consumer warpgroups
constexpr int kBQ = kBM * kConsumers;  // query rows per block
constexpr int kBK = 128;               // keys per tile
constexpr int kStages = 3;             // K/V stages in the ring
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileBytes = kBK * kD * 2;  // one K or V tile, bf16
constexpr int kQBytes = kBQ * kD * 2;
constexpr int kSchedBar = 1;  // named barriers 1, 2 (0 is __syncthreads)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory. Tiles are 1024-byte aligned: the 128-byte swizzle
// repeats every 8 rows of 128 bytes, and the descriptors assume the
// pattern starts at the tile.
struct Smem {
  alignas(1024) __nv_bfloat16 q[2][kBQ * kD];
  alignas(1024) __nv_bfloat16 k[kStages][kBK * kD];
  alignas(1024) __nv_bfloat16 v[kStages][kBK * kD];
  alignas(8) uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_empty[kStages];
};
constexpr int kSmemBytes = (int)sizeof(Smem) + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (64 of D, 128 rows) of a (D, S, H, B) tensor map into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(s), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from touching a register that an asynchronous wgmma
// still reads or writes: its value is "used and redefined" here
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Matrix descriptor of a 128-byte-swizzled tile: start address, leading
// and stride byte offsets (16-byte units), layout 1 = 128-byte swizzle.
// K-major (Q, K: D contiguous): 8-row groups 1024 bytes apart, the
// leading offset unused. MN-major (V as the B of P.V: D contiguous, keys
// along the product's K): one 64-wide swizzle atom along D, 8-key groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// s (+)= Q.K^T for one k-step of 16: m64n128k16, both operands in shared
// memory, K-major; scale_d = 0 starts the sum
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// o += P.V for one k-step of 16 keys: m64n64k16, P's A fragment in
// registers, V in shared memory MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

// Key tiles that rows [r0, r0 + rows) see, and the block's: a causal row
// i sees keys up to i + S_k - S_q. Rows past S_q see none.
__device__ __forceinline__ int tiles_for(int r0, int rows, int Sq, int Sk,
                                         int causal) {
  if (r0 >= Sq) return 0;
  const int last = min(r0 + rows, Sq) - 1;
  const int kend = causal ? min(Sk, last + 1 + Sk - Sq) : Sk;
  return (kend + kBK - 1) / kBK;
}

// The r-th work item of block j: items are (query tile, b*H + h) pairs
// numbered longest causal tile first (item i is query tile nq - 1 - i /
// BH of head i % BH), dealt to the blocks in a snake order (j, then
// 2G - 1 - j, then 2G + j, ...), so that every block's sum of tiles is
// within one tile of the mean at the LM's shape. -1 past the last item.
__device__ __forceinline__ int item_of(int r, int j, int G, int n_items) {
  const int i = r * G + ((r & 1) ? G - 1 - j : j);
  return i < n_items ? i : -1;
}

// A persistent grid: one block per SM walks its work items. The producer
// runs ahead across items: the next item's Q (two buffers) and its first
// K/V tiles load while the consumers finish the current one.
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int H, int Sq, int Sk,
                   float scale_log2, int causal, int nq, int n_items) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int BH = n_items / nq;
  const int G = gridDim.x, blk = blockIdx.x;
  // the warpgroup's index, read from lane 0 so that the compiler knows it
  // is uniform across the warp: branches on it are then not divergent,
  // and the wgmma instructions under them are not serialized
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.q_full[s], 1);
      mbar_init(&sm.q_empty[s], kConsumers * 4);  // lane 0 of each warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers * 4);
      mbar_init(&sm.v_empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers * 128) {
      int t = 0;  // K/V tiles loaded so far, across items
      for (int r = 0;; ++r) {
        const int i = item_of(r, blk, G, n_items);
        if (i < 0) break;
        const int bh = i % BH, q0 = (nq - 1 - i / BH) * kBQ;
        const int b = bh / H, h = bh - b * H;
        const int qb = r & 1;
        if (r >= 2) mbar_wait(&sm.q_empty[qb], ((r >> 1) - 1) & 1);
        mbar_expect_tx(&sm.q_full[qb], kQBytes);
        tma_load(sm.q[qb], &tq, &sm.q_full[qb], q0, h, b);
        // K and V stages are released apart: a K tile once Q.K^T has
        // read it, a V tile once P.V has, a window later
        const int nt = tiles_for(q0, kBQ, Sq, Sk, causal);
        for (int it = 0; it < nt; ++it, ++t) {
          const int st = t % kStages;
          const uint32_t par = ((t / kStages) - 1) & 1;
          if (t >= kStages) mbar_wait(&sm.k_empty[st], par);
          mbar_expect_tx(&sm.k_full[st], kTileBytes);
          tma_load(sm.k[st], &tk, &sm.k_full[st], it * kBK, h, b);
          if (t >= kStages) mbar_wait(&sm.v_empty[st], par);
          mbar_expect_tx(&sm.v_full[st], kTileBytes);
          tma_load(sm.v[st], &tv, &sm.v_full[st], it * kBK, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int c = lane & 3;
    const int off = Sk - Sq;

    float s[64];      // S of one tile, then its P in fp32
    float o[32];      // O, rows row and row + 8, 64 columns
    uint32_t ph[8][4], pl[8][4];  // P_hi and P_lo, as A fragments
    float m[2], l[2];  // running max (base 2); this thread's share of the sum
    float alpha[2];    // the factor that takes O to the new max
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) ph[kk][r] = pl[kk][r] = 0u;

    int t0 = 0;  // the block's K/V tiles before this item's
    int r0 = 0, row = 0;  // this warpgroup's first row, this thread's (+ 8)
    uint64_t dq = 0;
    // S = Q.K^T of tile it (t0 + it in the ring)
    auto issue_s = [&](int it) {
      const uint64_t dk = desc_sw128(sm.k[(t0 + it) % kStages], 1);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // 32 bytes per k-step
        wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk);
      wg_commit();
    };
    // O += P_lo.V, then P_hi.V, of tile it: 16 keys of 128 bytes per
    // k-step, the small terms first
    auto issue_pv = [&](int it) {
      const uint64_t dv = desc_sw128(sm.v[(t0 + it) % kStages], 1024 >> 4);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_pv(o, pl[kk], dv + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_pv(o, ph[kk], dv + 128 * kk);
      wg_commit();
    };
    // tile it's softmax: masked (only on tiles that cross the diagonal or
    // S_k), scaled into base 2 by one multiply-add with the max, folded
    // into the running max and sum; a row's 128 values sit in the four
    // lanes of a quad. Leaves P in s.
    auto softmax = [&](int it, auto masked) {
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(s[i]);
      const int k0 = it * kBK;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = row + 8 * hf;
        if constexpr (decltype(masked)::value) {
          // a masked key's score is -inf here, so its weight is exactly 0,
          // as -1e30 gives it in the TPU kernel (every row sees key 0 in
          // tile 0, so no row's running max stays at its -1e30 start)
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * j + 2 * c + e;
              if (key >= Sk || (causal && key > rr + off))
                s[4 * j + 2 * hf + e] = neg_inf();
            }
        }
        // max and sum over the thread's 32 values in four independent
        // chains, not one chain of 32 dependent steps
        float mq[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mq[(j & 1) * 2 + e] = fmaxf(mq[(j & 1) * 2 + e], s[4 * j + 2 * hf + e]);
        float mx = fmaxf(fmaxf(mq[0], mq[1]), fmaxf(mq[2], mq[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // the max in base-2 units: scale_log2 > 0 keeps the order
        const float m_new = fmaxf(m[hf], mx * scale_log2);
        alpha[hf] = ex2(m[hf] - m_new);
        float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hf + e;
            const float p = ex2(fmaf(s[i], scale_log2, -m_new));
            s[i] = p;
            sq[(j & 1) * 2 + e] += p;
          }
        l[hf] = l[hf] * alpha[hf] + ((sq[0] + sq[1]) + (sq[2] + sq[3]));
        m[hf] = m_new;
      }
      // the softmax is done here, before the caller waits for P.V: the
      // compiler may not sink it below that wait, or it would not overlap
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(s[i]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        reg_fence(l[hf]);
        reg_fence(alpha[hf]);
      }
    };
    // after P.V of the previous tile completed: O to the new max, and P
    // as bf16 halves. S's fragment (row, keys 8j + 2c, +1) pairs are P's
    // A fragment of k-step j/2 as they stand: register r of k-step kk
    // holds s[8kk + 2r], s[8kk + 2r + 1]
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
          const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
          ph[kk][r] = __byte_perm(xb, yb, 0x7632);  // the high halves
          pl[kk][r] = bf2_bits(
              __floats2bfloat162_rn(x - __uint_as_float(xb & 0xffff0000u),
                                    y - __uint_as_float(yb & 0xffff0000u)));
        }
    };
    auto pv_done = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(o[i]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg_fence(ph[kk][r]);
          reg_fence(pl[kk][r]);
        }
    };
    // this warpgroup is done with tile it's K or V. A tile it skips is
    // released all the same, maybe before it has even landed: that is
    // safe because the turns on the named barriers keep the warpgroups
    // within a window of each other, so every warpgroup has released the
    // stage's previous tile before anyone releases this one
    auto release_k = [&](int it) {
      if (lane == 0) mbar_arrive(&sm.k_empty[(t0 + it) % kStages]);
    };
    auto release_v = [&](int it) {
      if (lane == 0) mbar_arrive(&sm.v_empty[(t0 + it) % kStages]);
    };
    auto k_wait = [&](int it) {
      const int t = t0 + it;
      mbar_wait(&sm.k_full[t % kStages], (t / kStages) & 1);
    };
    auto v_wait = [&](int it) {
      const int t = t0 + it;
      mbar_wait(&sm.v_full[t % kStages], (t / kStages) & 1);
    };
    // Window w issues S = Q.K^T of tile w and O += P.V of tile w - 1, then
    // runs tile w's softmax while P.V runs
    auto window = [&](int w, auto masked) {
      k_wait(w);
      named_sync(kSchedBar + wg);
      wg_fence();
      issue_s(w);
      issue_pv(w - 1);
      named_arrive(kSchedBar + (wg ^ 1));
      wg_wait<1>();
      release_k(w);
      softmax(w, masked);
      // V of tile w, for the next window's P.V. Its wait is a loop, so it
      // also keeps the wait for P.V below the softmax: within one block
      // of straight-line code the compiler would hoist that wait above
      // the softmax, and the softmax would no longer run under P.V
      v_wait(w);
      wg_wait<0>();
      pv_done();
      release_v(w - 1);
      rescale_and_split();
    };

    if (wg == 1) named_arrive(kSchedBar);  // warpgroup 0 goes first
    for (int r = 0;; ++r) {
      const int i = item_of(r, blk, G, n_items);
      if (i < 0) break;
      const int bh = i % BH, q0 = (nq - 1 - i / BH) * kBQ;
      const int nt = tiles_for(q0, kBQ, Sq, Sk, causal);
      r0 = q0 + wg * kBM;
      row = r0 + warp * 16 + (lane >> 2);
      const int n_wg = tiles_for(r0, kBM, Sq, Sk, causal);
      // tiles before n_full need no mask: every key in them is below S_k
      // and, when causal, visible from the warpgroup's first row
      const int n_full =
          min(n_wg, (causal ? min(r0 + off + 1, Sk) : Sk) / kBK);
      const int qb = r & 1;
      dq = desc_sw128(sm.q[qb] + wg * kBM * kD, 1);
      m[0] = m[1] = kNeg;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;

      // Every warpgroup takes nt + 1 windows per item, some of them empty,
      // so the turns on the named barriers match; the wgmma instructions
      // sit outside any branch that differs between windows, so the
      // compiler keeps them in flight.
      int w = 0;
      if (n_wg > 0) {
        mbar_wait(&sm.q_full[qb], (r >> 1) & 1);
        k_wait(0);
        named_sync(kSchedBar + wg);
        wg_fence();
        issue_s(0);
        named_arrive(kSchedBar + (wg ^ 1));
        wg_wait<0>();
        release_k(0);
        if (n_full > 0)
          softmax(0, std::false_type());
        else
          softmax(0, std::true_type());
        v_wait(0);
        rescale_and_split();
        // windows 1 .. n_wg - 1: the tiles no mask touches, then the rest
        for (w = 1; w < n_full; ++w) window(w, std::false_type());
        for (; w < n_wg; ++w) window(w, std::true_type());
        named_sync(kSchedBar + wg);
        wg_fence();
        issue_pv(w - 1);
        named_arrive(kSchedBar + (wg ^ 1));
        wg_wait<0>();
        pv_done();
        release_v(w - 1);
        ++w;
      }
      for (; w <= nt; ++w) {  // the tiles this warpgroup's rows cannot see
        named_sync(kSchedBar + wg);
        named_arrive(kSchedBar + (wg ^ 1));
        if (w > 0) {
          release_k(w - 1);
          release_v(w - 1);
        }
      }
      if (lane == 0) mbar_arrive(&sm.q_empty[qb]);  // Q is read
      t0 += nt;

      // O / l, rounded once to bf16: rows row and row + 8, columns 8j + 2c
      // and 8j + 2c + 1 in o[4j + 2hf], o[4j + 2hf + 1]
      __nv_bfloat16* op = out + (long long)bh * Sq * kD;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float sum = l[hf];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int rr = row + 8 * hf;
        if (rr >= Sq) continue;
        const float den = fmaxf(sum, 1e-30f);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              o[4 * jj + 2 * hf] / den, o[4 * jj + 2 * hf + 1] / den);
          *reinterpret_cast<__nv_bfloat162*>(op + (long long)rr * kD +
                                              8 * jj + 2 * c) = pair;
        }
      }
    }
    if (wg == 0) named_sync(kSchedBar);  // warpgroup 1's last turn
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (D, S, H, B) map of one bf16 tensor: D contiguous, S, H and B at
// the given byte strides; boxes of 64 x 128 rows, 128-byte swizzle, rows
// past S read as zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int S,
                int H, int B, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, (cuuint32_t)kBK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// C entry point (bound with ctypes). q, k, v: bfloat16 (B, H, S, 64) with
// D contiguous; strides: the (b, h, s) element strides of q, then k, then
// v, each a multiple of 8 (16 bytes), and every base 16-byte aligned: the
// wrapper's route rule. out: contiguous (B, H, Sq, 64) bfloat16. Launches
// on `stream` and does not synchronize. Returns 0 on success, a CUDA
// runtime error code (cudaErrorInvalidValue for arguments the kernel does
// not take), or 10000 + the driver's CUresult when a tensor map cannot be
// encoded.
extern "C" int mxtt_flash_attention_sm90_fwd(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int H, int Sq, int Sk,
                                             const long long* strides,
                                             float sm_scale, int causal,
                                             void* stream) {
  const int nq = (Sq + kBQ - 1) / kBQ;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (causal && Sq > Sk) ||
      (long long)nq * B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* bases[3] = {q, k, v};
  for (int t = 0; t < 3; ++t) {
    if ((uintptr_t)bases[t] % 16) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 3; ++i) {
      const long long s = strides[3 * t + i];
      if (s <= 0 || s % 8 || s >= (1LL << 39)) return (int)cudaErrorInvalidValue;
    }
  }
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  CUtensorMap maps[3];
  const int seq[3] = {Sq, Sk, Sk};
  for (int t = 0; t < 3; ++t) {
    const CUresult r = encode(fn, &maps[t], bases[t], seq[t], H, B,
                              strides + 3 * t);
    if (r != CUDA_SUCCESS) return 10000 + (int)r;
  }
  err = cudaFuncSetAttribute(flash_fwd_sm90,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_items = nq * B * H;
  flash_fwd_sm90<<<min(n_sm, n_items), kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), H, Sq, Sk,
      sm_scale * kLog2e, causal, nq, n_items);
  return (int)cudaGetLastError();
}
