// Greedy non-maximum suppression (N1) over score-sorted boxes, for Hopper.
//
// Not a TPU kernel: it replaces the `lax.fori_loop` of `box_nms`
// (mxnet_tpu/ndarray/ops_contrib.py:82-88), which XLA compiled into one
// device program. A plain PyTorch port of that loop is a Python loop
// whose every row launches several kernels (SSD300: N = 8732 rows, so
// tens of thousands of launches per detection batch, and no CUDA graph
// could hold it). The sort before the sweep stays `torch.sort`.
//
// What it computes, per image b, on the rows i < L (L = min(N, topk)):
//   keep[i] = valid[i] at the start;
//   for i in 0..L-1 in order: if keep[i], clear keep[j] for every j > i
//     whose IoU with row i exceeds `thresh`, where the IoU counts as 0
//     when `ids` is given and the two rows' class ids differ;
//   rows at or past L are not kept.
// That is the JAX loop's `keep & vs`: a row that is suppressed or invalid
// suppresses nothing. The IoU is computed as `_corner_iou` computes it
// (ops_contrib.py), each difference, product, sum and the quotient
// rounded on its own (the `_rn` intrinsics, which nvcc never contracts
// into an FMA), so the keep mask equals the plain version's bit for bit.
//
// Bound: the boxes (16 bytes a row), the valid mask and the ids are read
// once and the keep mask written once, a few hundred KB at SSD300's
// (32, 8732); the IoU tests the greedy order needs (about 14 flops each)
// are microseconds at the fp32 rate. What no design removes is the chain
// of dependent steps: row i's fate is known only after every kept row
// before it has been swept.
//
// Design: the pairs in parallel, then one sequential OR-reduce.
//   - The suppression bitmask: bit t of word (i, c) is set when row
//     j = 64 c + t lies after row i, before L, and overlaps row i by more
//     than `thresh` within its class. Only the words right of the
//     diagonal (c >= i / 64) exist. They are packed as a triangle of row
//     blocks: row block r (rows 64 r .. 64 r + 63) holds W - r words a
//     row, W = ceil(L / 64), its rows one after another.
//   - The reduce: one warp walks the rows in order with the "removed"
//     bits in registers, word w in lane w % 32, starting as ~valid with
//     the rows past L removed. Word w's 64 rows are decided by every
//     lane at once from their diagonal words alone (row i is kept when
//     its bit is still clear, and then ORs its diagonal word in): a
//     chain of register operations a row, the loads ahead of it. The
//     kept rows' other words are then ORed into each lane's words in
//     parallel. When the walk ends, keep = ~removed. (A first design
//     passed each kept row's word by __shfl_sync and ORed from shared
//     memory on the chain: about 400 cycles a kept row on the card.)
//   - Route "mask_reduce" (any L whose ring fits shared memory): `nms_mask`
//     builds the
//     triangle in device memory across the whole card, one block per
//     (image, row block, 4 column blocks), each staging its column boxes
//     in shared memory and writing 4 contiguous words a row; then
//     `nms_reduce`, one block per image, streams the triangle through a
//     ring of shared-memory stages filled by bulk asynchronous copies
//     (`cp.async.bulk` completing on mbarriers) from a producer warp. The
//     ring runs whole stages ahead of the walk and loads every row, kept
//     or not, so the walk waits on shared memory, not on HBM. Past 512
//     words (32,768 rows) the removed bits no longer fit one warp's
//     registers: they stay in shared memory (`walk_shared`), and stages
//     of 4 rows or 2 keep two of them in shared memory up to about
//     370,000 rows on an H100. (A stage of one row would break the bulk
//     copy's 16-byte rule where a row holds an odd number of words.)
//   - Route "fused" (the triangle of one image fits in shared memory:
//     L up to 1,664 on an H100; the route rule takes it up to 256 rows,
//     where it beat mask_reduce on the card): one block per image loads
//     its L boxes, builds the triangle in shared memory and walks it, in
//     one launch; one or two rows it decides directly, with no barrier.
//   - The IoU test has no branch and no division: two products of the
//     union with the threshold's margins decide every pair whose IoU
//     lies more than 2^-19 (relative) from the threshold, exactly as the
//     rounded quotient would (Thresh says why); the rest, rare, take the
//     rounded quotient (__fdiv_rn) apart.
//   - A wait on a broken ring traps (a launch failure) after about 9 s of
//     spinning instead of hanging the card.
// The kernels allocate nothing: the caller passes the triangle's device
// memory (mask_reduce) and the plan (rows a stage, stages). The
// triangles grow as the square of L: the wrapper sweeps as many images a
// launch as a quarter of the card's memory holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kWaitTrap = 1LL << 34;  // clock64 cycles, ~9 s
constexpr int kGroup = 4;                    // column blocks a mask block
constexpr int kFusedThreads = 512;
constexpr int kDiagBatch = 16;  // diagonal words the walk loads ahead
constexpr int kMaxDevices = 64;
constexpr int kMaxWords = 32768;  // group_sum and the grid stay in range
constexpr int kRegWords = 512;    // removed bits a warp holds in registers

__device__ __forceinline__ float box_area(float4 a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f),
                   fmaxf(__fsub_rn(a.w, a.y), 0.f));
}

// The threshold and the margins that let a product decide most pairs
// without a division. With hi = t (1 + 2^-19) and lo = t (1 - 2^-19),
// each rounded, and the union u in [2^-100, 2^100] (so u hi and u lo are
// normal): inter > RN(u hi) gives inter / u > t (1 + 2^-20), whose
// rounding lies above t; inter < RN(u lo) gives inter / u < t (1 -
// 2^-20), whose rounding lies below t. Every other pair, and every pair
// under a threshold outside [2^-20, 2^20] or with areas out of range
// (row_in_range, col_in_range), takes the rounded quotient (__fdiv_rn),
// so the bit is always `RN(inter / u) > t`, the plain version's test.
struct Thresh {
  float t, lo, hi;
  bool fast;
  __device__ explicit Thresh(float thresh)
      : t(thresh),
        lo(thresh * (1.f - 0x1p-19f)),
        hi(thresh * (1.f + 0x1p-19f)),
        fast(thresh >= 0x1p-20f && thresh <= 0x1p20f) {}
};

// `_corner_iou(a, b) > t`, exactly, areas given
__device__ __forceinline__ bool over_exact(float4 a, float area_a, float4 b,
                                           float area_b, float t) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > t;
}

// One pair's test without a branch, for a fast threshold and operands
// in range (see Thresh): `hit` when the products decide that the IoU
// exceeds the threshold, `amb` when they cannot decide (the exact test
// then runs apart). A pair that does not intersect (inter 0) has IoU 0:
// neither.
__device__ __forceinline__ void over_fast(float4 a, float area_a, float4 b,
                                          float area_b, const Thresh& th,
                                          bool& hit, bool& amb) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  hit = inter > __fmul_rn(uni, th.hi);
  amb = !hit && inter > 0.f && !(inter < __fmul_rn(uni, th.lo));
}

// Whether the products may decide row a's pairs: with area_a in
// [2^-98, 2^98] and every column area in [0, 2^98], each union lies in
// [2^-100, 2^100] (inter is at most the smaller area, so the union is at
// least about the larger one, and at most their sum).
__device__ __forceinline__ bool row_in_range(float area_a) {
  return area_a >= 0x1p-98f && area_a <= 0x1p98f;
}
__device__ __forceinline__ bool col_in_range(float area_b) {
  return area_b >= 0.f && area_b <= 0x1p98f;
}

// one word of the bitmask: row i (box a) against the 64 rows of column
// block cb, staged at cbox/carea/cid; only the columns j with i < j < L
// are tested, the other bits stay clear. `fast` says that the threshold
// and the areas let the products decide (Thresh): a whole block of
// columns (the common case) runs in four unrolled runs of 16, small
// enough for the instruction cache; otherwise, and for the rare pairs
// the products leave undecided, the exact test runs.
template <bool kIds>
__device__ __forceinline__ uint64_t mask_word(
    int i, float4 a, float area_a, float id_a, int cb, const float4* cbox,
    const float* carea, const float* cid, int L, const Thresh& th,
    bool fast) {
  const int j0 = cb * 64;
  const int t0 = max(0, i + 1 - j0), t1 = min(64, L - j0);
  uint64_t word = 0, amb = 0;
  if (!fast) {
    for (int t = t0; t < t1; ++t) {
      bool hit = over_exact(a, area_a, cbox[t], carea[t], th.t);
      if (kIds && cid[t] != id_a) hit = 0.f > th.t;
      word |= static_cast<uint64_t>(hit) << t;
    }
    return word;
  }
  if (t0 == 0 && t1 == 64) {
#pragma unroll 1
    for (int g = 0; g < 64; g += 16) {
      unsigned hits = 0, unsure = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        bool hit, amb_t;
        over_fast(a, area_a, cbox[g + t], carea[g + t], th, hit, amb_t);
        if (kIds) {
          const bool same = cid[g + t] == id_a;
          hit = hit && same;
          amb_t = amb_t && same;
        }
        hits |= static_cast<unsigned>(hit) << t;
        unsure |= static_cast<unsigned>(amb_t) << t;
      }
      word |= static_cast<uint64_t>(hits) << g;
      amb |= static_cast<uint64_t>(unsure) << g;
    }
  } else {
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      bool hit, amb_t;
      over_fast(a, area_a, cbox[t], carea[t], th, hit, amb_t);
      if (kIds) {
        const bool same = cid[t] == id_a;
        hit = hit && same;
        amb_t = amb_t && same;
      }
      word |= static_cast<uint64_t>(hit) << t;
      amb |= static_cast<uint64_t>(amb_t) << t;
    }
  }
  while (amb != 0) {  // rare: IoUs within 2^-19 of the threshold
    const int t = __ffsll(static_cast<long long>(amb)) - 1;
    if (over_exact(a, area_a, cbox[t], carea[t], th.t)) word |= 1ull << t;
    amb &= amb - 1;
  }
  return word;
}

// mask_word for two rows a and a2 at once against a whole block of
// columns that lies after both and before L, both rows fast: each column
// box is loaded once for the two tests (the fused kernel's build)
template <bool kIds>
__device__ __forceinline__ void mask_word_pair(
    float4 a, float area_a, float id_a, float4 a2, float area_a2,
    float id_a2, const float4* cbox, const float* carea, const float* cid,
    const Thresh& th, uint64_t& word, uint64_t& word2) {
  uint64_t amb = 0, amb2 = 0;
  word = word2 = 0;
#pragma unroll 1
  for (int g = 0; g < 64; g += 16) {
    unsigned h = 0, u = 0, h2 = 0, u2 = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const float4 b = cbox[g + t];
      const float area_b = carea[g + t];
      bool hit, unsure, hit2, unsure2;
      over_fast(a, area_a, b, area_b, th, hit, unsure);
      over_fast(a2, area_a2, b, area_b, th, hit2, unsure2);
      if (kIds) {
        const float id_b = cid[g + t];
        const bool same = id_b == id_a, same2 = id_b == id_a2;
        hit = hit && same;
        unsure = unsure && same;
        hit2 = hit2 && same2;
        unsure2 = unsure2 && same2;
      }
      h |= static_cast<unsigned>(hit) << t;
      u |= static_cast<unsigned>(unsure) << t;
      h2 |= static_cast<unsigned>(hit2) << t;
      u2 |= static_cast<unsigned>(unsure2) << t;
    }
    word |= static_cast<uint64_t>(h) << g;
    amb |= static_cast<uint64_t>(u) << g;
    word2 |= static_cast<uint64_t>(h2) << g;
    amb2 |= static_cast<uint64_t>(u2) << g;
  }
  while (amb != 0) {  // rare: IoUs within 2^-19 of the threshold
    const int t = __ffsll(static_cast<long long>(amb)) - 1;
    if (over_exact(a, area_a, cbox[t], carea[t], th.t)) word |= 1ull << t;
    amb &= amb - 1;
  }
  while (amb2 != 0) {
    const int t = __ffsll(static_cast<long long>(amb2)) - 1;
    if (over_exact(a2, area_a2, cbox[t], carea[t], th.t)) {
      word2 |= 1ull << t;
    }
    amb2 &= amb2 - 1;
  }
}

// mask blocks (kGroup column blocks each) of the row blocks whose rows
// have n words or fewer: sum over k = 1 .. n of ceil(k / kGroup)
__host__ __device__ __forceinline__ int group_sum(int n) {
  const int q = n / kGroup, r = n % kGroup;
  return kGroup * q * (q + 1) / 2 + r * (q + 1);
}

// words before row block rb in one image's triangle
__host__ __device__ __forceinline__ long long tri_base(int rb, int W) {
  return 64LL * (static_cast<long long>(rb) * W -
                 static_cast<long long>(rb) * (rb - 1) / 2);
}

// -- the walk ----------------------------------------------------------------

// The removed bits at the start into `words` (W words in shared memory):
// invalid rows and rows past L removed. Warp `warp` of `warps` takes
// words warp, warp + warps, ...: two ballots over 64 coalesced bytes a
// word.
__device__ __forceinline__ void removed_at_start(uint64_t* words,
                                                 const uint8_t* valid, int L,
                                                 int W, int warp, int warps,
                                                 int lane) {
#pragma unroll 4
  for (int w = warp; w < W; w += warps) {
    const int j = w * 64 + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, j < L && valid[j]);
    const unsigned hi =
        __ballot_sync(0xffffffffu, j + 32 < L && valid[j + 32]);
    if (lane == 0) words[w] = ~(static_cast<uint64_t>(hi) << 32 | lo);
  }
}

// The sequential OR-reduce by one warp, its removed bits in registers:
// word kk * 32 + lane in rem[kk], from `words`, rem only ever indexed by
// constants. The walk takes word w's 64 rows in chunks of R: `rows.
// chunk(w, c)` gives rows 64 w + c R .. + R - 1 in shared memory, row t
// at t * (W - w), each holding its words of column blocks w .. W - 1
// (after whatever wait that needs), and `rows.release()` hands the chunk
// back. Every lane holds word w in `cur` and resolves the chunk's rows
// in order from their first (diagonal) words alone, loaded 16 ahead:
// a row whose bit in `cur` is clear is kept and ORs its diagonal word
// into `cur`, a chain of a few register operations a row. Then each lane
// ORs the kept rows' other words into its own words, and word w's owner
// takes `cur`. Rows at or past L are removed from the start and their
// chunks past the last are not visited.
template <int K, int R, class Rows>
__device__ __forceinline__ void walk(uint64_t (&rem)[K],
                                     const uint64_t* words, int L, int W,
                                     int lane, Rows& rows) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int w0 = kk * 32 + lane;
    rem[kk] = w0 < W ? words[w0] : ~0ull;
  }
  for (int w = 0; w < W; ++w) {
    const int kw = w >> 5;
    uint64_t mine = rem[0];
#pragma unroll
    for (int kk = 1; kk < K; ++kk) {
      if (kk == kw) mine = rem[kk];
    }
    uint64_t cur = __shfl_sync(0xffffffffu, mine, w & 31);
    const int len = W - w;
    for (int c = 0; c < 64 / R && w * 64 + c * R < L; ++c) {
      const uint64_t* base = rows.chunk(w, c);
      const int b0 = c * R;
      // the rows' fates: a select, not a branch, so that no lane waits to
      // reconverge on the chain
      uint64_t kept = 0;
#pragma unroll
      for (int t0 = 0; t0 < R; t0 += kDiagBatch) {
        if (w * 64 + b0 + t0 >= L) break;  // the rest lie past L: removed
        uint64_t diag[kDiagBatch];
#pragma unroll
        for (int t = 0; t < kDiagBatch; ++t) {
          diag[t] = base[(t0 + t) * len];
        }
#pragma unroll
        for (int t = 0; t < kDiagBatch; ++t) {
          const int b = b0 + t0 + t;
          const uint64_t sel = 0ull - ((~cur >> b) & 1ull);  // kept: all ones
          cur |= diag[t] & sel;
          kept |= sel & (1ull << b);
        }
      }
      // the kept rows' other words (none in the last word)
      if (w + 1 < W) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const uint64_t sel = 0ull - ((kept >> (b0 + t)) & 1ull);
          const uint64_t* row = base + t * len;
#pragma unroll
          for (int k2 = 0; k2 < K; ++k2) {
            const int wq = k2 * 32 + lane;
            if (wq > w && wq < W) rem[k2] |= row[wq - w] & sel;
          }
        }
      }
      rows.release();
    }
    if (lane == (w & 31)) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if (kk == kw) rem[kk] = cur;
      }
    }
  }
  rows.done();
}

// The walk with the removed bits in `words` in shared memory, for sweeps
// past kRegWords words, whose bits do not fit one warp's registers, and
// for stages of fewer than kDiagBatch rows: the chain is `walk`'s, from
// word w read by every lane, and a kept row ORs its other words into
// `words` lane by lane (word w + 1 + lane, w + 33 + lane, ...).
template <int R, class Rows>
__device__ __forceinline__ void walk_shared(uint64_t* words, int L, int W,
                                            int lane, Rows& rows) {
  constexpr int kB = R < kDiagBatch ? R : kDiagBatch;
  for (int w = 0; w < W; ++w) {
    __syncwarp();  // the last word's ORs land before word w is read
    uint64_t cur = words[w];
    const int len = W - w;
    for (int c = 0; c < 64 / R && w * 64 + c * R < L; ++c) {
      const uint64_t* base = rows.chunk(w, c);
      const int b0 = c * R;
      uint64_t kept = 0;
#pragma unroll
      for (int t0 = 0; t0 < R; t0 += kB) {
        if (w * 64 + b0 + t0 >= L) break;  // the rest lie past L: removed
        uint64_t diag[kB];
#pragma unroll
        for (int t = 0; t < kB; ++t) diag[t] = base[(t0 + t) * len];
#pragma unroll
        for (int t = 0; t < kB; ++t) {
          const int b = b0 + t0 + t;
          const uint64_t sel = 0ull - ((~cur >> b) & 1ull);  // kept: all ones
          cur |= diag[t] & sel;
          kept |= sel & (1ull << b);
        }
      }
      // the same `kept` in every lane: a uniform loop over the kept rows
      for (uint64_t k = kept; k != 0; k &= k - 1) {
        const uint64_t* row =
            base + (__ffsll(static_cast<long long>(k)) - 1 - b0) * len;
        for (int wq = w + 1 + lane; wq < W; wq += 32) words[wq] |= row[wq - w];
      }
      rows.release();
    }
    if (lane == 0) words[w] = cur;
  }
  __syncwarp();
  rows.done();
}

// keep = ~removed for the rows before min(N, 64 W), from the W words of
// removed bits in `words`: the warp's lanes write neighbouring bytes
__device__ __forceinline__ void store_keep(const uint64_t* words,
                                           uint8_t* keep, int N, int W,
                                           int lane) {
  const int n = min(N, W * 64);
  for (int j = lane; j < n; j += 32) {
    keep[j] = (words[j >> 6] >> (j & 63)) & 1 ? 0 : 1;
  }
}

// `walk`'s removed bits into `words`, then keep = ~removed
template <int K>
__device__ __forceinline__ void walk_store(const uint64_t (&rem)[K],
                                           uint64_t* words, uint8_t* keep,
                                           int N, int W, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int w = kk * 32 + lane;
    if (w < W) words[w] = rem[kk];
  }
  __syncwarp();
  store_keep(words, keep, N, W, lane);
}

// -- mbarriers and bulk copies ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
// wait until the phase of parity `parity` has completed; trap after
// kWaitTrap cycles of spinning (a broken ring)
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
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- route mask_reduce: the mask kernel ---------------------------------------

// grid (group_sum(W), 1, B), 64 threads: block t of an image is group g
// of row block rb (the row blocks' groups one after another), and thread
// r takes row 64 rb + r against column blocks cb0 .. cb0 + kGroup - 1,
// cb0 = rb + kGroup g
template <bool kIds>
__global__ void __launch_bounds__(64, 16)
nms_mask(const float4* __restrict__ boxes, const float* __restrict__ ids,
         uint64_t* __restrict__ mask, int N, int L, int W, float thresh) {
  __shared__ float4 s_box[kGroup * 64];
  __shared__ float s_area[kGroup * 64];
  __shared__ float s_id[kGroup * 64];
  // the last row block whose first group is at or before this block
  const int blk = blockIdx.x, total = group_sum(W);
  int lo = 0, hi = W - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (total - group_sum(W - mid) <= blk) lo = mid; else hi = mid - 1;
  }
  const int rb = lo;
  const int cb0 = rb + (blk - (total - group_sum(W - rb))) * kGroup;
  const int ncb = min(kGroup, W - cb0);
  const size_t img = blockIdx.z;
  boxes += img * N;
  if (kIds) ids += img * N;
  bool cols_ok = true;
  for (int t = threadIdx.x; t < ncb * 64; t += 64) {
    const int j = cb0 * 64 + t;
    const float4 b = j < L ? boxes[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    s_box[t] = b;
    s_area[t] = box_area(b);
    cols_ok = cols_ok && col_in_range(s_area[t]);
    if (kIds) s_id[t] = j < L ? ids[j] : 0.f;
  }
  cols_ok = __syncthreads_and(cols_ok);
  const int r = threadIdx.x;
  const int i = rb * 64 + r;
  const Thresh th(thresh);
  uint64_t* out = mask + img * static_cast<size_t>(tri_base(W, W)) +
                  tri_base(rb, W) + static_cast<long long>(r) * (W - rb) +
                  (cb0 - rb);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float area_a = 0.f, id_a = 0.f;
  if (i < L) {
    a = boxes[i];
    area_a = box_area(a);
    if (kIds) id_a = ids[i];
  }
  const bool fast = th.fast && cols_ok && row_in_range(area_a);
#pragma unroll 1
  for (int q = 0; q < ncb; ++q) {
    out[q] = i < L ? mask_word<kIds>(i, a, area_a, id_a, cb0 + q,
                                     s_box + q * 64, s_area + q * 64,
                                     s_id + q * 64, L, th, fast)
                   : 0ull;
  }
}

// -- route mask_reduce: the reduce kernel -------------------------------------

// The walk's view of the ring: stage s holds rows s R .. s R + R - 1
// (all in one row block, R dividing 64), in slot s % S; the walk takes
// the stages in order.
struct Ring {
  const uint64_t* slots;
  uint64_t* full;
  uint64_t* empty;
  int S, n_stages, slot_words;
  int lane;
  int cur;  // the next stage to take

  __device__ __forceinline__ const uint64_t* chunk(int, int) {
    mbar_wait(&full[cur % S], (cur / S) & 1);
    return slots + static_cast<size_t>(cur % S) * slot_words;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();  // every lane's reads of the slot come before its release
    if (lane == 0) mbar_arrive(&empty[cur % S]);
    ++cur;
  }
  // any stage the walk did not take still arrives: wait for every copy,
  // so none lands in the shared memory of a finished block
  __device__ __forceinline__ void done() {
    for (; cur < n_stages; ++cur) mbar_wait(&full[cur % S], (cur / S) & 1);
  }
};

// one block of two warps per image: warp 1's lane 0 fills the ring, warp
// 0 walks, its removed bits in K registers a lane (`walk`) or, with K 0,
// in shared memory (`walk_shared`). Shared memory: S slots of
// `slot_words`, 2 S mbarriers, then W words of removed bits.
template <int K, int R>
__global__ void __launch_bounds__(64)
nms_reduce(const uint64_t* __restrict__ mask, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int N, int L, int W, int S,
           int slot_words) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* slots = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = slots + static_cast<size_t>(S) * slot_words;
  uint64_t* empty = full + S;
  uint64_t* words = empty + S;
  const size_t img = blockIdx.x;
  mask += img * static_cast<size_t>(tri_base(W, W));
  valid += img * N;
  keep += img * N;
  const int n_stages = (L + R - 1) / R;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 1);  // the walk's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    if (threadIdx.x == 32) {
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % S, use = s / S;
        if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
        const int rb = (s * R) >> 6;
        const int len = W - rb;
        const uint32_t bytes = static_cast<uint32_t>(R) * len * 8;
        mbar_expect_tx(&full[slot], bytes);
        bulk_load(slots + static_cast<size_t>(slot) * slot_words,
                  mask + tri_base(rb, W) +
                      static_cast<long long>(s * R - rb * 64) * len,
                  bytes, &full[slot]);
      }
    }
    for (int j = W * 64 + threadIdx.x - 32; j < N; j += 32) keep[j] = 0;
    return;
  }
  removed_at_start(words, valid, L, W, 0, 1, lane);
  __syncwarp();
  Ring ring{slots, full, empty, S, n_stages, slot_words, lane, 0};
  if constexpr (K == 0) {
    walk_shared<R>(words, L, W, lane, ring);
    store_keep(words, keep, N, W, lane);
  } else {
    uint64_t rem[K];
    walk<K, R>(rem, words, L, W, lane, ring);
    walk_store<K>(rem, words, keep, N, W, lane);
  }
}

// -- route fused --------------------------------------------------------------

// the fused kernel's rows: the whole triangle in shared memory, a chunk
// a word
struct SharedRows {
  const uint64_t* tri;
  int W;
  __device__ __forceinline__ const uint64_t* chunk(int w, int) const {
    return tri + tri_base(w, W);
  }
  __device__ __forceinline__ void release() const {}
  __device__ __forceinline__ void done() const {}
};

// one block per image (64 to 512 threads); shared memory: the triangle
// (64 W (W + 1) / 2 words), 64 W boxes, areas and ids (zeros past L),
// then W words of removed bits; W <= 32
template <bool kIds>
__global__ void __launch_bounds__(kFusedThreads)
nms_fused(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
          const float* __restrict__ ids, uint8_t* __restrict__ keep, int N,
          int L, int W, float thresh) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Lp = W * 64;
  uint64_t* tri = reinterpret_cast<uint64_t*>(smem);
  float4* s_box = reinterpret_cast<float4*>(tri + tri_base(W, W));
  float* s_area = reinterpret_cast<float*>(s_box + Lp);
  float* s_id = s_area + Lp;
  uint64_t* words = reinterpret_cast<uint64_t*>(s_id + Lp);
  const size_t img = blockIdx.x;
  const int lane = threadIdx.x & 31;
  boxes += img * N;
  valid += img * N;
  keep += img * N;
  if (kIds) ids += img * N;
  if (L <= 2) {
    // one or two rows: nothing to build or walk; thread 0 decides them
    // in one round of loads, with no barrier (the general path's
    // barriers cost more than such a sweep: timed on the card)
    if (threadIdx.x == 0 && L > 0) {
      const int last = L - 1;  // every load first, in one round
      const bool v0 = valid[0], v1 = valid[last];
      const float4 a = boxes[0], b = boxes[last];
      const float id0 = kIds ? ids[0] : 0.f, id1 = kIds ? ids[last] : 0.f;
      keep[0] = v0;
      if (L == 2) {
        bool gone = v0 && over_exact(a, box_area(a), b, box_area(b), thresh);
        if (kIds && id0 != id1) gone = v0 && 0.f > thresh;
        keep[1] = v1 && !gone;
      }
    }
    for (int j = L + threadIdx.x; j < N; j += blockDim.x) keep[j] = 0;
    return;
  }
  bool cols_ok = true;
  for (int j = threadIdx.x; j < Lp; j += blockDim.x) {
    const float4 b = j < L ? boxes[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    s_box[j] = b;
    s_area[j] = box_area(b);
    cols_ok = cols_ok && col_in_range(s_area[j]);
    if (kIds) s_id[j] = j < L ? ids[j] : 0.f;
  }
  // the last warps take the valid flags, so their loads overlap the
  // first warps' box loads
  const int warps = blockDim.x >> 5;
  removed_at_start(words, valid, L, W, warps - 1 - (threadIdx.x >> 5), warps,
                   lane);
  for (int j = Lp + threadIdx.x; j < N; j += blockDim.x) keep[j] = 0;
  cols_ok = __syncthreads_and(cols_ok);
  // item (c, r) of row block rb: rows 64 rb + r and 64 rb + r + 32
  // against column block rb + c, the items of all row blocks one after
  // another; a warp takes 32 row pairs of one column block, whose boxes
  // it broadcasts
  const Thresh th(thresh);
  const int items = 16 * W * (W + 1);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int rb = 0, rest = it;
    while (rest >= 32 * (W - rb)) {
      rest -= 32 * (W - rb);
      ++rb;
    }
    const int len = W - rb;
    const int c = rest >> 5, r = rest & 31;
    const int i0 = rb * 64 + r, i1 = i0 + 32, cb = rb + c;
    const bool fast0 = th.fast && cols_ok && row_in_range(s_area[i0]);
    const bool fast1 = th.fast && cols_ok && row_in_range(s_area[i1]);
    uint64_t w0 = 0, w1 = 0;
    if (cb > rb && cb * 64 + 64 <= L && i1 < L && fast0 && fast1) {
      mask_word_pair<kIds>(s_box[i0], s_area[i0], kIds ? s_id[i0] : 0.f,
                           s_box[i1], s_area[i1], kIds ? s_id[i1] : 0.f,
                           s_box + cb * 64, s_area + cb * 64,
                           s_id + cb * 64, th, w0, w1);
    } else {
      if (i0 < L) {
        w0 = mask_word<kIds>(i0, s_box[i0], s_area[i0],
                             kIds ? s_id[i0] : 0.f, cb, s_box + cb * 64,
                             s_area + cb * 64, s_id + cb * 64, L, th, fast0);
      }
      if (i1 < L) {
        w1 = mask_word<kIds>(i1, s_box[i1], s_area[i1],
                             kIds ? s_id[i1] : 0.f, cb, s_box + cb * 64,
                             s_area + cb * 64, s_id + cb * 64, L, th, fast1);
      }
    }
    tri[tri_base(rb, W) + r * len + c] = w0;
    tri[tri_base(rb, W) + (r + 32) * len + c] = w1;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  uint64_t rem[1];
  SharedRows rows{tri, W};
  walk<1, 64>(rem, words, L, W, lane, rows);
  walk_store<1>(rem, words, keep, N, W, lane);
}

// -- launch ----------------------------------------------------------------

// raise a kernel's dynamic shared memory limit on the current device,
// once a device and a kernel
template <class F>
cudaError_t raise_smem(F* fn, bool (&raised)[kMaxDevices], size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) raised[dev] = true;
  return cudaSuccess;
}

template <bool kIds>
cudaError_t launch_fused(const void* boxes, const void* valid, const void* ids,
                         void* keep, int B, int N, int L, int W, float thresh,
                         cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const size_t smem = static_cast<size_t>(tri_base(W, W)) * 8 +
                      static_cast<size_t>(W) * (64 * 24 + 8);
  cudaError_t err = raise_smem(nms_fused<kIds>, raised, smem);
  if (err != cudaSuccess) return err;
  // a small sweep takes a small block: 64 threads a word, up to 512
  const int threads =
      W <= 1 ? 64 : (W <= 2 ? 128 : (W >= 8 ? kFusedThreads : 64 * W));
  nms_fused<kIds><<<B, threads, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(ids), static_cast<uint8_t*>(keep), N, L, W,
      thresh);
  return cudaGetLastError();
}

template <int K, int R>
cudaError_t launch_reduce(const uint64_t* mask, const void* valid, void* keep,
                          int B, int N, int L, int W, int S,
                          cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const int slot_words = R * W;
  const size_t smem = static_cast<size_t>(S) * (slot_words * 8 + 16) +
                      static_cast<size_t>(W) * 8;
  cudaError_t err = raise_smem(nms_reduce<K, R>, raised, smem);
  if (err != cudaSuccess) return err;
  nms_reduce<K, R><<<B, 64, smem, stream>>>(
      mask, static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
      N, L, W, S, slot_words);
  return cudaGetLastError();
}

}  // namespace

// All three: boxes (B, N, 4) float32 corner boxes in score order, valid
// (B, N) bool, ids (B, N) float32 class ids or null (class-blind), keep
// (B, N) bool out, mask the triangles of B images (B * 32 * W * (W + 1)
// int64 words, W = ceil(L / 64)); all contiguous, boxes and mask 16-byte
// aligned, on the current device, 0 <= L <= N. Each launches one kernel
// on `stream` without synchronizing and returns a cudaError_t (0:
// launched; cudaErrorInvalidValue for sizes or a plan it does not take).

// Route "fused": the whole sweep in one launch; L up to 64 * 32 rows and
// the triangle in shared memory.
extern "C" int mxtt_box_nms_fused(const void* boxes, const void* valid,
                                  const void* ids, void* keep, int B, int N,
                                  int L, float thresh, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int W = (L + 63) / 64;
  if (L < 0 || L > N || W > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ids != nullptr
             ? launch_fused<true>(boxes, valid, ids, keep, B, N, L, W, thresh,
                                  s)
             : launch_fused<false>(boxes, valid, ids, keep, B, N, L, W,
                                   thresh, s);
}

// Route "mask_reduce", its first kernel: the triangles into `mask`.
extern "C" int mxtt_box_nms_mask(const void* boxes, const void* ids,
                                 void* mask, int B, int N, int L,
                                 float thresh, void* stream) {
  const int W = (L + 63) / 64;
  if (B <= 0 || N <= 0 || W == 0) return 0;
  if (L < 0 || L > N || W > kMaxWords || B > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(group_sum(W), 1, B);
  uint64_t* m = static_cast<uint64_t*>(mask);
  if (ids != nullptr) {
    nms_mask<true><<<grid, 64, 0, s>>>(static_cast<const float4*>(boxes),
                                       static_cast<const float*>(ids), m, N,
                                       L, W, thresh);
  } else {
    nms_mask<false><<<grid, 64, 0, s>>>(static_cast<const float4*>(boxes),
                                        nullptr, m, N, L, W, thresh);
  }
  return cudaGetLastError();
}

// Route "mask_reduce", its second kernel: the walk over `mask`, each
// stage of the ring R rows (64, 16, 4 or 2: the most of which two stages
// fit shared memory; R even keeps every stage's bytes and address a
// multiple of 16), S stages (at least 2).
extern "C" int mxtt_box_nms_reduce(const void* mask, const void* valid,
                                   void* keep, int B, int N, int L, int R,
                                   int S, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int W = (L + 63) / 64;
  if (L < 0 || L > N || W > kMaxWords || S < 2 ||
      (R != 64 && R != 16 && R != 4 && R != 2)) {
    return cudaErrorInvalidValue;
  }
  const uint64_t* m = static_cast<const uint64_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W > kRegWords || R < kDiagBatch) {  // the removed bits in shared memory
    switch (R) {
      case 64: return launch_reduce<0, 64>(m, valid, keep, B, N, L, W, S, s);
      case 16: return launch_reduce<0, 16>(m, valid, keep, B, N, L, W, S, s);
      case 4: return launch_reduce<0, 4>(m, valid, keep, B, N, L, W, S, s);
      default: return launch_reduce<0, 2>(m, valid, keep, B, N, L, W, S, s);
    }
  }
  // the removed bits take ceil(W / 32) registers of 64 bits a lane
  if (R == 64) {
    if (W <= 64) {
      return launch_reduce<2, 64>(m, valid, keep, B, N, L, W, S, s);
    }
    if (W <= 160) {
      return launch_reduce<5, 64>(m, valid, keep, B, N, L, W, S, s);
    }
    if (W <= 256) {
      return launch_reduce<8, 64>(m, valid, keep, B, N, L, W, S, s);
    }
    return launch_reduce<0, 64>(m, valid, keep, B, N, L, W, S, s);
  }
  if (W <= 256) {
    return launch_reduce<8, 16>(m, valid, keep, B, N, L, W, S, s);
  }
  return launch_reduce<16, 16>(m, valid, keep, B, N, L, W, S, s);
}

// The shared memory a block of the current device may take (the opt-in
// limit), for the wrapper's route rule.
extern "C" int mxtt_box_nms_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}
