// int8 x int8 -> int32 convolution (N2) for Hopper: an implicit GEMM over
// NHWC activations and OHWI weights on `wgmma` s8, fed by TMA through an
// mbarrier ring.
//
// Not a TPU kernel: like csrc/int8_conv.cu (the `mma.sync` kernel it
// stands beside) it replaces what XLA compiles for
// `lax.conv_general_dilated(int8, int8, preferred_element_type=int32)`,
// mxnet_tpu/ndarray/ops_quant.py:341-346 (the `native` lowering of
// `_contrib_quantized_conv`) and mxnet_tpu/contrib/quantization.py:124-133
// (`QuantizedConv2D`). It exists because PyTorch has no int8 convolution
// on CUDA that accumulates in int32: `F.conv2d` refuses int8 CUDA tensors.
// The wrapper (`int8_conv`, mxnet_tpu_torch/kernels/int8_conv.py) sends
// here what `_int8_conv_route` gives "sm90": one group, C and O multiples
// of 16, 2-D or lifted 1-D; grouped and other convolutions stay with
// csrc/int8_conv.cu.
//
// What it computes, with K ordered (r, s, c):
//   y[n, o, ho, wo] = sum over r < kh, s < kw, c < C of
//       x[n, ho*sh - ph + r*dh, wo*sw - pw + s*dw, c] * w[o, r, s, c]
// with taps outside the image counting 0, summed in int32: exact, so any
// order of summation and any split of K gives the same bits as the plain
// version (`_int8_conv_ref`, a float64 convolution rounded to int32).
// x arrives NHWC and w as OHWI (the wrapper's copies, `to_nhwc_kernel`
// below, where it holds NCHW and OIHW); y leaves NCHW.
//
// Bound at resnet50_v1's 53 convolutions at batch 32: 0.521 ms a forward
// (`chip_smoke.py` phase 48), set by bytes: the int8 input and weights
// read once and the int32 output written once, 1.70 GB at 3.35 TB/s, of
// which the output is 1.36 GB. Only the 3 x 3 convolutions at 14 x 14 and
// 7 x 7 are bound by their operations (2*M*O*K at 1,979 int8 TOPS); the
// operations of the whole forward take 0.125 ms. What the design does
// about that:
//   - the products run as `wgmma.mma_async.m64nBNk32.s32.s8.s8`, the only
//     way to the card's int8 tensor rate. 8-bit wgmma reads both operands
//     from shared memory K-major only, which NHWC and OHWI give: A rows are
//     output pixels, B rows filters, and a stage's k-tile is 128 bytes of
//     C at one tap (r, s), one row of the 128-byte swizzle;
//   - a block computes a 128 x BN tile (BN 64, 128 or 256, `_sm90_plan`),
//     two consumer warpgroups of 64 pixel rows each, accumulating in int32
//     registers, while one producer thread keeps a ring of (A, B) stages
//     in flight on full and empty mbarriers: as many stages as shared
//     memory holds beside the epilogue's tile (4 to 7);
//   - every operand comes by TMA, one box per stage each, zeros past the
//     edges: B from a 3-D map over (C, kh*kw, O), so channels past C (C
//     below 128) read as zeros. A: for a 1 x 1 convolution at stride 1
//     the NHWC activation is the (M, C) matrix, and the tile is 128
//     consecutive pixels of a 2-D map over it. Every other convolution
//     takes a spatial tile, Nt images x Ht rows x Wt columns of output
//     pixels (at most 128), from a 4-D map over (C, W, H, N): the box for
//     tap (r, s) starts at the tile's corner shifted by (r*dh - ph,
//     s*dw - pw), steps through the image at the convolution's stride
//     (the map's element strides), and reads the padding as zeros: the
//     im2col is the TMA's addressing, and no thread computes an address;
//   - the grid is persistent (one block per SM): a block walks work items
//     (pixel tile, filter tile, K split), and the producer loads the next
//     item's stages while the consumers store this one's. Where a cost
//     model in the wrapper finds it pays (few tiles, long K), K is split
//     across items and the parts are added into a zeroed output with int32
//     atomics: exact and order-free, so reruns are bitwise equal;
//   - the epilogue stages 32 or 64 filters x 64 pixels of each
//     warpgroup's accumulators in shared memory (a 68-int pitch:
//     conflict-free both ways) and writes each filter's run of pixels to
//     the NCHW output: 16-byte stores where four pixels are neighbours in
//     one output row, else 4-byte stores by consecutive threads, never
//     4-byte stores at stride H*W.
// chip_smoke.py (phase 48) and tools/compare_kernels.py time it beside the
// `mma.sync` kernel (`route="mma"`), `torch._int_mm` on an explicit im2col
// and cuDNN's float32 convolution of the codes; PERF.md keeps the numbers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // output pixels per tile
constexpr int kBK = 128;           // bytes of K per stage: one swizzle row
constexpr int kConsumers = 2;      // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kEpiPitch = 64 + 4;  // ints per staged filter row
constexpr int kSmemMax = 232448;   // a block's dynamic shared memory
// ~9 s of spinning on one barrier is a fault in the ring: trap, not hang
constexpr long long kWaitTrap = 1LL << 34;

// Per tile width: filters per epilogue pass, and as many stages as fit
template <int BN>
struct Cfg {
  static constexpr int kEpiCols = BN == 256 ? 32 : 64;
  static constexpr int kStageBytes = (kBM + BN) * kBK;
  static constexpr int kEpiBytes = kConsumers * kEpiCols * kEpiPitch * 4;
  static constexpr int kFit = (kSmemMax - 2048 - kEpiBytes) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
};

// Shared memory. Tiles are 1024-byte aligned: the 128-byte swizzle
// repeats every 8 rows, and the descriptors assume it starts at the tile.
template <int BN>
struct Smem {
  static constexpr int S = Cfg<BN>::kStages;
  alignas(1024) int8_t a[S][kBM * kBK];
  alignas(1024) int8_t b[S][BN * kBK];
  alignas(16) int32_t c[kConsumers][Cfg<BN>::kEpiCols * kEpiPitch];
  alignas(8) uint64_t full[S];
  uint64_t empty[S];
};

struct Conv {
  int32_t* y;  // NCHW
  int N, O, Ho, Wo, KW, sh, sw, ph, pw, dh, dw;
  int M, HoWo;        // output pixels, per image
  int cblocks;        // 128-byte blocks of C
  int k_tiles;        // kh * kw * cblocks
  int Nt, Ht, Wt;     // a spatial tile (flat tiles: 128 pixels)
  int tw, th;         // spatial tiles across W and H
  int rows;           // pixel rows a tile loads: Nt * Ht * Wt, or 128
  int n_tiles, splits, items;
  int vec_out;        // four pixels of a quad are neighbours in a row
};

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
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kWaitTrap) {
      __trap();
    }
  }
}

// one box of a tensor map into shared memory, counted in bytes on `bar`;
// coordinates innermost first
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
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
// keep the compiler from touching an accumulator that an asynchronous
// wgmma still writes: its value is "used and redefined" here
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Matrix descriptor of a K-major tile whose 128-byte rows are rows of the
// 128-byte swizzle: start address, leading offset unused (1), 8-row groups
// 1024 bytes apart, layout type 1. A k-step of 32 bytes advances the start
// address by 2 (16-byte units) within the swizzle row.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A.B^T for one k-step of 32 bytes: m64nBNk32, s8 x s8 -> s32, both
// operands in shared memory, K-major
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// -- the kernel --------------------------------------------------------------

// Work item i: split i % splits of filter tile (i / splits) % n_tiles of
// pixel tile i / (splits * n_tiles): the blocks working side by side share
// a pixel tile, so its A is read from device memory about once. K split s
// covers k-tiles [s * k_tiles / splits, (s + 1) * k_tiles / splits); k-tile
// kt is 128 bytes of C (block kt % cblocks) at tap kt / cblocks.
struct Item {
  int mt, nt, kb, ke;
};
__device__ __forceinline__ Item item_of(const Conv& p, int i) {
  Item it;
  const int s = i % p.splits;
  const int tile = i / p.splits;
  it.nt = tile % p.n_tiles;
  it.mt = tile / p.n_tiles;
  it.kb = (int)((long long)s * p.k_tiles / p.splits);
  it.ke = (int)((long long)(s + 1) * p.k_tiles / p.splits);
  return it;
}

// A spatial pixel tile's first output position (n, h, w): tiles run along
// W, then H, then images
struct Origin {
  int n, h, w;
};
__device__ __forceinline__ Origin origin_of(const Conv& p, int mt) {
  const int tx = mt % p.tw, rest = mt / p.tw;
  return Origin{(rest / p.th) * p.Nt, (rest % p.th) * p.Ht, tx * p.Wt};
}

// The y offset (at filter 0) of tile row r, and whether that pixel exists
__device__ __forceinline__ long long pixel_of(const Conv& p, bool flat,
                                              int mt, int r, bool& ok) {
  if (flat) {
    const int m = mt * kBM + r;
    ok = m < p.M;
    const int n = ok ? m / p.HoWo : 0;
    return (long long)n * p.O * p.HoWo + (m - n * p.HoWo);
  }
  const Origin o = origin_of(p, mt);
  const int ww = r % p.Wt, hw = r / p.Wt;
  const int n = o.n + hw / p.Ht, h = o.h + hw % p.Ht, w = o.w + ww;
  ok = r < p.rows && n < p.N && h < p.Ho && w < p.Wo;
  return ((long long)n * p.O * p.Ho + h) * p.Wo + w;
}

// The epilogue of one warpgroup: its 64 rows x BN accumulators to the NCHW
// output, a pass of filters at a time through shared memory. Thread (warp
// w, lane l) holds rows 16w + l/4 (+ 8) and columns 8j + 2(l%4) (+ 1) in
// acc[4j + 2hf + e]. Reading back, where four neighbouring tile rows are
// neighbouring pixels of one output row on a 16-byte boundary (p.vec_out),
// a thread stores rows 4q .. 4q + 3 (q = tid % 16) of filters tid / 16 +
// 8i with one 16-byte store; else a warp stores 32 neighbouring rows of
// one filter (tid % 64 its row, filters tid / 64 + 2i), 4 bytes a thread,
// or adds them where K is split.
template <int BN, bool kFlat>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2],
                                           int32_t* sc, const Conv& p,
                                           const Item& it, int wg, int tid) {
  constexpr int kEpiCols = Cfg<BN>::kEpiCols;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = warp * 16 + (lane >> 2), cq = lane & 3;
  const bool atomic = p.splits > 1;
  const bool vec = p.vec_out && !atomic;
  const int q = tid & 15, fr = tid >> 4;  // the 16-byte stores' roles
  const int pr = tid & 63, fg = tid >> 6;  // the 4-byte stores'
  bool ok;
  const long long ob = pixel_of(p, kFlat, it.mt, wg * 64 + (vec ? 4 * q : pr),
                                ok);
#pragma unroll
  for (int c0 = 0; c0 < BN; c0 += kEpiCols) {
    const int o0 = it.nt * BN + c0;
    if (o0 >= p.O) break;
    named_sync(1 + wg);  // the previous pass has read the staging tile
#pragma unroll
    for (int jj = 0; jj < kEpiCols / 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sc[(8 * jj + 2 * cq + e) * kEpiPitch + row + 8 * hf] =
              acc[4 * (c0 / 8 + jj) + 2 * hf + e];
    named_sync(1 + wg);
    if (!ok) continue;
    if (vec) {
#pragma unroll 2
      for (int f = fr; f < kEpiCols && o0 + f < p.O; f += 8)
        *reinterpret_cast<int4*>(p.y + ob + (long long)(o0 + f) * p.HoWo) =
            *reinterpret_cast<const int4*>(&sc[f * kEpiPitch + 4 * q]);
    } else {
#pragma unroll 4
      for (int f = fg; f < kEpiCols && o0 + f < p.O; f += 2) {
        int32_t* dst = p.y + ob + (long long)(o0 + f) * p.HoWo;
        const int v = sc[f * kEpiPitch + pr];
        if (atomic)
          atomicAdd(dst, v);
        else
          *dst = v;
      }
    }
  }
}

// A persistent grid: block j walks items j, j + gridDim.x, ... Warpgroups
// 0 and 1 consume; one thread of warpgroup 2 produces. The stage ring
// runs on across items, so the producer loads the next item while the
// consumers store. kFlat: A from the 2-D (M, C) map; else from the 4-D
// (C, W, H, N) map, one box per tap.
template <int BN, bool kFlat>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel_sm90(const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap ta, Conv p) {
  constexpr int S = Cfg<BN>::kStages;
  extern __shared__ unsigned char smem_raw[];
  Smem<BN>& sm = *reinterpret_cast<Smem<BN>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  // the warpgroup's index, read from lane 0 so that the compiler knows it
  // is uniform: the wgmma under branches on it is then not serialized
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);                // the producer's expect_tx
      mbar_init(&sm.empty[s], kConsumers * 4);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      // a stage: B's box (BN filters x 128 bytes) and A's (its pixel rows x
      // 128 bytes); boxes past the tensor's edges still count in full
      const uint32_t bytes = (uint32_t)(BN + p.rows) * kBK;
      int t = 0;
      for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
        const Item it = item_of(p, i);
        Origin o{0, 0, 0};
        if (!kFlat) {
          o = origin_of(p, it.mt);
          o.h = o.h * p.sh - p.ph;  // input position of tap (0, 0)
          o.w = o.w * p.sw - p.pw;
        }
        for (int kt = it.kb; kt < it.ke; ++kt, ++t) {
          const int st = t % S;
          if (t >= S) mbar_wait(&sm.empty[st], ((t / S) - 1) & 1);
          const int tap = kt / p.cblocks;
          const int c = (kt - tap * p.cblocks) * kBK;
          mbar_expect_tx(&sm.full[st], bytes);
          tma_load(sm.b[st], &tb, &sm.full[st], c, tap, it.nt * BN);
          if (kFlat) {
            tma_load(sm.a[st], &ta, &sm.full[st], c, it.mt * kBM);
          } else {
            const int r = tap / p.KW;
            tma_load(sm.a[st], &ta, &sm.full[st], c,
                     o.w + (tap - r * p.KW) * p.dw, o.h + r * p.dh, o.n);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x - wg * 128;
    const int lane = tid & 31;
    int acc[BN / 2];
    int t = 0;
    for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
      const Item it = item_of(p, i);
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
      for (int kt = it.kb; kt < it.ke; ++kt, ++t) {
        const int st = t % S;
        mbar_wait(&sm.full[st], (t / S) & 1);
        const uint64_t da = desc_k(sm.a[st] + wg * 64 * kBK);
        const uint64_t db = desc_k(sm.b[st]);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks)
          wgmma_s8<BN>(acc, da + 2 * ks, db + 2 * ks);
        wg_commit();
        fence_acc(acc);
        // the previous k-tile's products are done: release its stage
        wg_wait<1>();
        fence_acc(acc);
        if (kt > it.kb && lane == 0)
          mbar_arrive(&sm.empty[(t + S - 1) % S]);
      }
      wg_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&sm.empty[(t + S - 1) % S]);
      store_tile<BN, kFlat>(acc, sm.c[wg], p, it, wg, tid);
    }
  }
}

// -- the layout copy ----------------------------------------------------------

// (N, C, P) int8 -> (N, P, Cp): each image's C x P matrix transposed,
// channels C .. Cp - 1 written as zeros. It makes the kernel's NHWC
// activations (P = H*W) and OHWI weights (N = O, P = kh*kw) where the
// wrapper holds NCHW and OIHW; one launch takes both. The output is the
// (N*P, Cp) matrix, and a block takes a tile of it, TC channels by some
// rows q = (n, p):
//   - P a multiple of 4 and TC 64 (the activations): 128 rows. A thread
//     reads 4 channels x 4 pixels as four 4-byte words along p,
//     transposes them in registers (__byte_perm) and stages them
//     pixel-major; the tile leaves in 16-byte stores along c;
//   - else (the weights' 9 or 49 taps, the 7 x 7 activations, C below 16
//     padded to TC 16): 4096 / TC rows, read a byte (or a word) at a time
//     along p, staged channel-major, written in 4-byte words along c.
struct Job {
  const int8_t* x;
  int8_t* y;
  int C, P, Cp, vec, blocks_q;
  long long NP;
};

constexpr int kVecRows = 128;      // rows of a tile on the transposing path
constexpr int kVecPitch = 64 + 16;  // bytes per staged pixel row

// the transposing path: 64 channels from c0 by kVecRows rows from q0
__device__ __forceinline__ void copy_tile_vec(uint8_t* o, const uint8_t* xs,
                                              uint8_t* ys, int C, int P,
                                              int Cp, long long NP,
                                              long long q0, int c0) {
  for (int u = threadIdx.x; u < 16 * (kVecRows / 4); u += 256) {
    const int p4 = u % (kVecRows / 4), c4 = u / (kVecRows / 4);
    const long long q = q0 + 4 * p4;
    uint32_t w[4];
    if (q < NP) {
      const long long n = q / P;
      const uint8_t* src = xs + (n * C + c0 + 4 * c4) * P + (q - n * P);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = c0 + 4 * c4 + i < C
                   ? *reinterpret_cast<const uint32_t*>(src + (long long)i * P)
                   : 0u;
    } else {
      w[0] = w[1] = w[2] = w[3] = 0u;
    }
    // word j of the result: byte j of each of the four channels' words
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
    uint8_t* dst = o + (4 * p4) * kVecPitch + 4 * c4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + kVecPitch) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * kVecPitch) =
        __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * kVecPitch) =
        __byte_perm(t1, t3, 0x7632);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < kVecRows * 4; u += 256) {
    const int r = u / 4, k = u % 4;
    if (q0 + r < NP && c0 + 16 * k < Cp)
      *reinterpret_cast<uint4*>(ys + (q0 + r) * Cp + c0 + 16 * k) =
          *reinterpret_cast<const uint4*>(o + r * kVecPitch + 16 * k);
  }
}

// the other path: TC channels from c0 by 4096 / TC rows from q0
template <int TC, bool kVec>
__device__ __forceinline__ void copy_tile(uint8_t* raw, const uint8_t* xs,
                                          uint8_t* ys, int C, int P, int Cp,
                                          long long NP, long long q0,
                                          int c0) {
  constexpr int TQ = 4096 / TC, kPitch = TQ + 4, kW = kVec ? 4 : 1;
  // the q a thread reads is the same on every pass: 256 is a multiple of
  // TQ / kW
  const int qq = (threadIdx.x % (TQ / kW)) * kW;
  const long long q = q0 + qq;
  const long long n = q / P;
  const uint8_t* src = xs + n * C * P + (q - n * P);
#pragma unroll 4
  for (int i = threadIdx.x; i < TC * TQ / kW; i += 256) {
    const int c = i / (TQ / kW);
    const bool ok = c0 + c < C && q < NP;
    if (kVec)
      *reinterpret_cast<uint32_t*>(raw + c * kPitch + qq) =
          ok ? *reinterpret_cast<const uint32_t*>(src + (long long)(c0 + c) *
                                                            P)
             : 0u;
    else
      raw[c * kPitch + qq] = ok ? src[(long long)(c0 + c) * P] : 0;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < TC * TQ / 4; i += 256) {
    const int r = i / (TC / 4), c = (i % (TC / 4)) * 4;
    if (q0 + r < NP && c0 + c < Cp) {
      const uint8_t* t = raw + c * kPitch + r;
      *reinterpret_cast<uint32_t*>(ys + (q0 + r) * Cp + c0 + c) =
          (uint32_t)t[0] | (uint32_t)t[kPitch] << 8 |
          (uint32_t)t[2 * kPitch] << 16 | (uint32_t)t[3 * kPitch] << 24;
    }
  }
}

template <int TC>
__global__ void __launch_bounds__(256)
    to_nhwc_kernel(const Job j0, const Job j1, int blocks0) {
  __shared__ __align__(16) uint8_t raw[kVecRows * kVecPitch];
  // this block's job, field by field (no copy of either to local memory)
  const bool second = (int)blockIdx.x >= blocks0;
  const uint8_t* xs = reinterpret_cast<const uint8_t*>(second ? j1.x : j0.x);
  uint8_t* ys = reinterpret_cast<uint8_t*>(second ? j1.y : j0.y);
  const int C = second ? j1.C : j0.C, P = second ? j1.P : j0.P;
  const int Cp = second ? j1.Cp : j0.Cp;
  const int blocks_q = second ? j1.blocks_q : j0.blocks_q;
  const long long NP = second ? j1.NP : j0.NP;
  const bool vec = second ? j1.vec : j0.vec;
  const int b = blockIdx.x - (second ? blocks0 : 0);
  const int c0 = (b / blocks_q) * TC;
  if (TC == 64 && vec)
    copy_tile_vec(raw, xs, ys, C, P, Cp, NP,
                  (long long)(b % blocks_q) * kVecRows, c0);
  else if (vec)
    copy_tile<TC, true>(raw, xs, ys, C, P, Cp, NP,
                        (long long)(b % blocks_q) * (4096 / TC), c0);
  else
    copy_tile<TC, false>(raw, xs, ys, C, P, Cp, NP,
                         (long long)(b % blocks_q) * (4096 / TC), c0);
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

// An int8 map of `rank` dimensions (innermost first, dims[0] contiguous,
// byte strides of the others), boxes of `box` elements traversed at
// `step`, 128-byte swizzle; reads past an edge give zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rank,
                const long long* dims, const long long* strides,
                const int* box, const int* step) {
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    e[i] = (cuuint32_t)step[i];
    if (i) s[i - 1] = (cuuint64_t)strides[i - 1];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base),
            d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, bool kFlat>
cudaError_t launch(const CUtensorMap& tb, const CUtensorMap& ta,
                   const Conv& p, int grid, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<BN>) + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      int8_conv_kernel_sm90<BN, kFlat>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int8_conv_kernel_sm90<BN, kFlat><<<grid, kThreads, smem, stream>>>(tb, ta,
                                                                     p);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). x: int8 NHWC (N, H, W, C), C a
// multiple of 16; w: int8 (O, KH, KW, C); y: int32 NCHW (N, O, Ho, Wo),
// zeroed by the caller when splits > 1; all three 16-byte aligned. From
// the wrapper's plan (`_sm90_plan`): bn (64, 128 or 256), splits (1 ..
// k-tiles), flat (a 1 x 1 convolution at stride 1 without padding: A as
// the (M, C) matrix) or else the spatial tile nt x ht x wt (at most 128
// pixels; wt * sw and ht * sh at most 256, sh and sw at most 8), and grid.
// Launches on `stream` and does not synchronize. Returns 0, a CUDA
// runtime error code (cudaErrorInvalidValue for arguments the kernel does
// not take), or 10000 + the driver's CUresult when a tensor map cannot be
// encoded.
extern "C" int mxtt_int8_conv_sm90(const int8_t* x, const int8_t* w,
                                   int32_t* y, int N, int C, int H, int W,
                                   int O, int KH, int KW, int Ho, int Wo,
                                   int sh, int sw, int ph, int pw, int dh,
                                   int dw, int bn, int splits, int flat,
                                   int nt, int ht, int wt, int grid,
                                   void* stream) {
  const long long M = (long long)N * Ho * Wo;
  if (N < 1 || C < 16 || C % 16 || H < 1 || W < 1 || O < 1 || KH < 1 ||
      KW < 1 || Ho < 1 || Wo < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 ||
      dh < 1 || dw < 1 || M >= (1LL << 31) ||
      (long long)KH * KW * C >= (1LL << 17) ||
      (long long)N * H * W * C >= (1LL << 40) ||
      (bn != 64 && bn != 128 && bn != 256) || grid < 1 ||
      (uintptr_t)x % 16 || (uintptr_t)w % 16 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  if (flat ? (KH != 1 || KW != 1 || sh != 1 || sw != 1 || ph || pw ||
              Ho != H || Wo != W)
           : (nt < 1 || ht < 1 || wt < 1 || nt * ht * wt > kBM ||
              wt * sw > 256 || ht * sh > 256 || nt > 256 || sh > 8 ||
              sw > 8))
    return (int)cudaErrorInvalidValue;
  Conv p{y, N, O, Ho, Wo, KW, sh, sw, ph, pw, dh, dw};
  p.M = (int)M;
  p.HoWo = Ho * Wo;
  p.cblocks = (C + kBK - 1) / kBK;
  p.k_tiles = KH * KW * p.cblocks;
  p.n_tiles = (O + bn - 1) / bn;
  p.splits = splits;
  long long m_tiles;
  if (flat) {
    p.Nt = p.Ht = p.Wt = 1;
    p.tw = p.th = 1;
    p.rows = kBM;
    m_tiles = (M + kBM - 1) / kBM;
    p.vec_out = p.HoWo % 4 == 0;
  } else {
    p.Nt = nt;
    p.Ht = ht;
    p.Wt = wt;
    p.tw = (Wo + wt - 1) / wt;
    p.th = (Ho + ht - 1) / ht;
    p.rows = nt * ht * wt;
    m_tiles = (long long)p.tw * p.th * ((N + nt - 1) / nt);
    p.vec_out = wt % 4 == 0 && Wo % 4 == 0;
  }
  const long long items = m_tiles * p.n_tiles * splits;
  if (splits < 1 || splits > p.k_tiles || items >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  CUtensorMap tb, ta;
  // B: (C, kh*kw, O), a box of 128 bytes of C at one tap by bn filters
  const long long bd[3] = {C, (long long)KH * KW, O};
  const long long bs[2] = {C, (long long)KH * KW * C};
  const int bbox[3] = {kBK, 1, bn}, one[4] = {1, 1, 1, 1};
  CUresult r = encode(fn, &tb, w, 3, bd, bs, bbox, one);
  if (r == CUDA_SUCCESS) {
    if (flat) {
      const long long ad[2] = {C, M};
      const long long as[1] = {C};
      const int abox[2] = {kBK, kBM};
      r = encode(fn, &ta, x, 2, ad, as, abox, one);
    } else {
      // A: (C, W, H, N); the box spans wt * sw columns and ht * sh rows,
      // stepping at the stride, so it loads wt x ht pixels of nt images
      const long long ad[4] = {C, W, H, N};
      const long long as[3] = {C, (long long)W * C, (long long)H * W * C};
      const int abox[4] = {kBK, wt * sw, ht * sh, nt};
      const int step[4] = {1, sw, sh, 1};
      r = encode(fn, &ta, x, 4, ad, as, abox, step);
    }
  }
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bn == 64)
    err = flat ? launch<64, true>(tb, ta, p, grid, st)
               : launch<64, false>(tb, ta, p, grid, st);
  else if (bn == 128)
    err = flat ? launch<128, true>(tb, ta, p, grid, st)
               : launch<128, false>(tb, ta, p, grid, st);
  else
    err = flat ? launch<256, true>(tb, ta, p, grid, st)
               : launch<256, false>(tb, ta, p, grid, st);
  return (int)err;
}

// C entry point: y (N, P, Cp) = x (N, C, P) transposed per image, channels
// C .. Cp - 1 zero (Cp a multiple of 16 and at least C, y 16-byte
// aligned), for one or two such copies (x2 null: one) in one launch.
// Launches on `stream`; returns 0 or a CUDA runtime error code.
extern "C" int mxtt_int8_to_nhwc(const int8_t* x, int8_t* y, int N, int C,
                                 int P, int Cp, const int8_t* x2, int8_t* y2,
                                 int N2, int C2, int P2, int Cp2,
                                 void* stream) {
  Job jobs[2];
  const int n_jobs = x2 ? 2 : 1;
  const void* xs[2] = {x, x2};
  int8_t* ys[2] = {y, y2};
  const int ns[2] = {N, N2}, cs[2] = {C, C2}, ps[2] = {P, P2},
            cps[2] = {Cp, Cp2};
  const int tc = (Cp == 16 || (x2 && Cp2 == 16)) ? 16 : 64;
  if (x2 && (Cp == 16) != (Cp2 == 16)) return (int)cudaErrorInvalidValue;
  long long blocks[2] = {0, 0};
  for (int k = 0; k < n_jobs; ++k) {
    const long long NP = (long long)ns[k] * ps[k];
    if (ns[k] < 1 || cs[k] < 1 || ps[k] < 1 || cps[k] < cs[k] ||
        cps[k] % 16 || (uintptr_t)ys[k] % 16 || NP * cps[k] >= (1LL << 40))
      return (int)cudaErrorInvalidValue;
    const bool vec = ps[k] % 4 == 0 && (uintptr_t)xs[k] % 4 == 0;
    const int tq = tc == 64 && vec ? kVecRows : 4096 / tc;
    const long long bq = (NP + tq - 1) / tq;
    jobs[k] = Job{static_cast<const int8_t*>(xs[k]), ys[k], cs[k], ps[k],
                  cps[k], vec, (int)bq, NP};
    blocks[k] = bq * ((cps[k] + tc - 1) / tc);
    if (bq >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  }
  if (n_jobs == 1) jobs[1] = jobs[0];
  if (blocks[0] + blocks[1] >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(blocks[0] + blocks[1]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc == 16)
    to_nhwc_kernel<16><<<grid, 256, 0, st>>>(jobs[0], jobs[1], (int)blocks[0]);
  else
    to_nhwc_kernel<64><<<grid, 256, 0, st>>>(jobs[0], jobs[1], (int)blocks[0]);
  return (int)cudaGetLastError();
}
