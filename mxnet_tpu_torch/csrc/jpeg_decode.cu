// The card's record decode: nvJPEG, then resize-short, crop and mirror.
//
// Not a TPU kernel: the JAX package decodes records on the host through
// libjpeg (native/recordio.cc, decode_one), with resize-short, crop and
// mirror fused into its decode loop. A machine with no libjpeg but a
// CUDA toolkit decodes here instead: nvJPEG (a library of the toolkit,
// as cuDNN is) decodes each JPEG at full size into the card's memory,
// interleaved RGB, and `jpeg_crop` makes the batch from those images
// with the CPU route's plan (kernels/jpeg_decode.py, `crop_plan`):
//
//   per image: the decoded size (w, h) and libjpeg's DCT scale 1/denom
//   (the largest power of two up to 8 that keeps the short edge at or
//   above resize_short), the scaled size (sw, sh) = ceil((w, h) / denom),
//   the resized size (tw, th), the crop's corner (cy, cx) and mirror.
//
// A scaled pixel is the rounded mean of its denom x denom block of the
// full-size image (libjpeg's scaled IDCT keeps the block's low
// frequencies: the same mean for 1/8, close to it for 1/2 and 1/4). The
// bilinear resize repeats decode_one's float arithmetic op by op
// (__fadd_rn, __fmul_rn, __fdiv_rn: nvcc would otherwise contract them
// into FMAs), so from the same full-size pixels at denom 1 the crop is
// bitwise the CPU route's; the pixels themselves differ by the two
// decoders' IDCT and chroma upsampling rounding (PERF.md states the
// bound measured on the card).
//
// Bound: bytes. The output is written once and the source bytes under
// the crop are read once: with no resize (the record pipeline's main
// path) one source byte an output byte, about 2 x 19 MB for a batch of
// 128 at 224 x 224 from 252 x 252 images, some 11.5 us at the card's
// 3.35 TB/s; with a resize, the full-size rows and columns that the
// crop's taps reach (tools/profile_records.py, crop_bound_ms).
//
// The crop runs as two kernels, one for each kind of image, each over
// the whole batch: a block of 256 threads makes a band of output rows of
// one image, which is one contiguous run of output bytes, and returns at
// once when its image is the other kernel's kind. The wrapper launches
// only the kernels the plan needs (kernels/jpeg_decode.py, crop_kinds):
// the record pipeline's crops without a resize launch copy_kernel alone.
// Threads 0-10 read the image's plan row once into shared memory.
//   - `copy_kernel`, no resize at scale 1: each output row is the source
//     span ((cy + y) * w + cx) * 3 .. + W * 3, read forward or
//     pixel-reversed when mirrored. The 16-byte-aligned run of source
//     bytes that encloses each row's span comes into shared memory by
//     16-byte `cp.async.cg` copies, every row of the band in flight at
//     once; chunks that would cross the source buffer's ends are read
//     byte by byte (kernels/jpeg_decode.py pads the nvJPEG buffer by 16
//     bytes so that the last image's spans never do). Read forward, each
//     thread assembles 16 output bytes from the staged span with funnel
//     shifts; mirrored, a thread a pixel reverses the pixels into an
//     output tile in shared memory first. 32 registers: eight blocks an
//     SM keep the copies in flight.
//   - `scaled_kernel`, a resize or a DCT scale: the rows' taps (y0, wy)
//     once a row and the columns' taps (x0, wx) once a block go into
//     shared memory; the scaled rows the band reads, over the columns it
//     reads, are staged once (copied at scale 1, block means at 1/2, 1/4,
//     1/8) in chunks of the band's rows that fit, so no block mean is
//     computed once for each tap and channel. A thread a pixel then
//     computes its three channels from the staged rows into the output
//     tile. Rows too wide to stage, or crops wider than the column table,
//     are read from the source directly, a thread a pixel.
//   - The output leaves in 16-byte stores: the tile sits in shared
//     memory at the offset modulo 16 its bytes have in device memory, so
//     each aligned 16 output bytes are one 16-byte load and one store;
//     only the band's ends, where its byte run is not 16-byte aligned,
//     take single-byte stores.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// plan row: offset of the image in the decoded buffer (bytes), w, h,
// denom, sw, sh, tw, th, cy, cx, mirror
constexpr int kPlan = 11;

__device__ __forceinline__ float scaled_px(const uint8_t* img, int w, int h,
                                           int denom, int r, int c, int ch) {
  if (denom == 1) return (float)img[((size_t)r * w + c) * 3 + ch];
  int r0 = r * denom, c0 = c * denom;
  int r1 = min(r0 + denom, h), c1 = min(c0 + denom, w);
  int sum = 0;
  for (int y = r0; y < r1; ++y)
    for (int x = c0; x < c1; ++x) sum += img[((size_t)y * w + x) * 3 + ch];
  int n = (r1 - r0) * (c1 - c0);
  return (float)((sum + n / 2) / n);
}

constexpr int kThreads = 256;     // a block of either crop kernel
constexpr int kCopyBlocks = 8;    // copy_kernel's blocks an SM keeps
constexpr int kScaledBlocks = 4;  // scaled_kernel's
constexpr int kBand = 16;         // output rows a block makes
constexpr int kTableMax = 4096;   // widest crop whose column taps stay in smem
constexpr int kStage = 20480;     // staged scaled rows of a resized band

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Bring `nrows` spans of `len` bytes, the first at `first` and each
// `pitch` bytes after the one before, into shared memory rows of
// `stride` bytes: row i holds the 16-byte-aligned run that encloses its
// span, the span starting (first + i * pitch) & 15 bytes in. Chunks that
// would reach outside [lo, hi) take single-byte loads of the bytes inside.
__device__ void stage_spans(uint8_t* sm, int stride, int nrows,
                            const uint8_t* first, size_t pitch, int len,
                            uintptr_t lo, uintptr_t hi) {
  const int chunks = stride / 16;
  for (int k = threadIdx.x; k < nrows * chunks; k += blockDim.x) {
    int i = k / chunks, j = k - i * chunks;
    uintptr_t a = (uintptr_t)(first + (size_t)i * pitch);
    uintptr_t g = (a & ~(uintptr_t)15) + (uintptr_t)j * 16;
    if (g >= a + (uintptr_t)len) continue;
    uint8_t* d = sm + (size_t)i * stride + j * 16;
    if (g >= lo && g + 16 <= hi) {
      cp_async16(d, (const void*)g);
    } else {
      for (int b = 0; b < 16; ++b)
        if (g + b >= lo && g + b < hi) d[b] = *(const uint8_t*)(g + b);
    }
  }
}

// decode_one's bilinear tap along one axis: output index o of t from s
__device__ __forceinline__ void tap(int o, int s, int t, int* i0,
                                    float* wt) {
  float f = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn((float)o, 0.5f),
                                          (float)s), (float)t), 0.5f);
  int i = f < 0 ? 0 : (int)f;
  float w = __fsub_rn(f, (float)i);
  *i0 = i;
  *wt = w < 0 ? 0 : w;
}

// One output pixel's three channels read from the source directly, as
// the first design (csrc/jpeg_crop_pixel.cu) computes them (rows too
// wide to stage, or a crop too wide for the column table): output column
// x, source column ox. Out of
// line: its taps and twelve block-mean loops would swell the staged
// path's code.
__device__ __noinline__ void direct_pixel(const uint8_t* img, int w, int h,
                                          int denom, int sw, int sh, int tw,
                                          bool identity, bool table,
                                          const int* t_x0, const float* t_wx,
                                          int ox, int x, int y0, float wy,
                                          uint8_t* d) {
  int x0 = ox;
  float wx = 0;
  if (table) {
    x0 = t_x0[x];
    wx = t_wx[x];
  } else if (!identity) {
    tap(ox, sw, tw, &x0, &wx);
  }
  if (identity) {
    for (int c = 0; c < 3; ++c)
      d[c] = (uint8_t)scaled_px(img, w, h, denom, y0, x0, c);
    return;
  }
  int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
  int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
  float ay = __fsub_rn(1.0f, wy), ax = __fsub_rn(1.0f, wx);
  for (int c = 0; c < 3; ++c) {
    float v00 = scaled_px(img, w, h, denom, y0, x0, c);
    float v01 = scaled_px(img, w, h, denom, y0, x1, c);
    float v10 = scaled_px(img, w, h, denom, y1, x0, c);
    float v11 = scaled_px(img, w, h, denom, y1, x1, c);
    float v = __fmul_rn(__fmul_rn(v00, ay), ax);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, ay), wx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), ax));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
    d[c] = (uint8_t)__float2uint_rz(__fadd_rn(v, 0.5f));
  }
}

// A block mean of the scaled image, out of line (staged once a value).
__device__ __noinline__ uint8_t block_mean(const uint8_t* img, int w, int h,
                                           int denom, int r, int c, int ch) {
  return (uint8_t)scaled_px(img, w, h, denom, r, c, ch);
}

// Write the band's bytes [o0, o0 + nbytes): 16-byte stores over the
// aligned middle, single bytes at the two ends. `vec(li)` and `byte(li)`
// give the output bytes from byte li of the band on.
template <typename Vec, typename Byte>
__device__ __forceinline__ void store_band(uint8_t* o0, size_t nbytes,
                                           Vec vec, Byte byte) {
  uintptr_t lo = (uintptr_t)o0, hi = lo + nbytes;
  uintptr_t va = (lo + 15) & ~(uintptr_t)15, vb = hi & ~(uintptr_t)15;
  if (va > vb) va = vb = hi;
  // a band is at most kBand rows of 3 x 65535 bytes: 32-bit offsets
  for (uintptr_t v = va + (uintptr_t)threadIdx.x * 16; v < vb;
       v += (uintptr_t)blockDim.x * 16)
    *reinterpret_cast<uint4*>(v) = vec((unsigned)(v - lo));
  unsigned head = (unsigned)(va - lo), ends = head + (unsigned)(hi - vb);
  for (unsigned t = threadIdx.x; t < ends; t += blockDim.x) {
    unsigned li = t < head ? t : (unsigned)(vb - lo) + (t - head);
    o0[li] = byte(li);
  }
}

// Run f(i, x) over the pixels of band rows r_begin <= i < r_end and
// columns x < W, a thread each, neighbouring threads on neighbouring
// pixels.
template <typename F>
__device__ __forceinline__ void each_pixel(int r_begin, int r_end, int W,
                                           F f) {
  int i = r_begin + (int)threadIdx.x / W;
  int x = (int)threadIdx.x % W;
  while (i < r_end) {
    f(i, x);
    x += blockDim.x;
    while (x >= W) {
      x -= W;
      ++i;
    }
  }
}

// The image's plan row, read once a block by threads 0-10.
struct Plan {
  const uint8_t* img;
  int w, h, denom, sw, sh, tw, th, cy, cx, mirror;
  // no resize at scale 1: copy_kernel's images; the others scaled_kernel's
  __device__ bool copies() const { return tw == sw && th == sh && denom == 1; }
};

__device__ __forceinline__ Plan read_plan(const uint8_t* src,
                                          const int64_t* plan, int n,
                                          long long* s_plan) {
  if (threadIdx.x < kPlan)
    s_plan[threadIdx.x] = plan[(size_t)n * kPlan + threadIdx.x];
  __syncthreads();
  Plan p;
  p.img = src + s_plan[0];
  p.w = (int)s_plan[1];
  p.h = (int)s_plan[2];
  p.denom = (int)s_plan[3];
  p.sw = (int)s_plan[4];
  p.sh = (int)s_plan[5];
  p.tw = (int)s_plan[6];
  p.th = (int)s_plan[7];
  p.cy = (int)s_plan[8];
  p.cx = (int)s_plan[9];
  p.mirror = (int)s_plan[10];
  return p;
}

// The images with no resize at scale 1 (the record pipeline's main
// path); a block on another image returns at once.
__global__ void __launch_bounds__(kThreads, kCopyBlocks)
    copy_kernel(const uint8_t* __restrict__ src, long long src_bytes,
                const int64_t* __restrict__ plan, int n_bands, int rows,
                int H, int W, int tile_bytes, int span,
                uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long s_plan[kPlan];
  __shared__ int s_lead[kBand];
  const int n = blockIdx.x / n_bands;
  const int r0 = (blockIdx.x - n * n_bands) * rows;
  const int nr = min(rows, H - r0);
  const Plan P = read_plan(src, plan, n, s_plan);
  if (!P.copies()) return;
  const uint8_t* img = P.img;
  const int w = P.w, cy = P.cy, cx = P.cx, mirror = P.mirror;
  const int L = W * 3;
  const uintptr_t lo = (uintptr_t)src, hi = lo + (uintptr_t)src_bytes;
  uint8_t* o0 = out + ((size_t)n * H + r0) * L;
  const size_t nbytes = (size_t)nr * L;
  const size_t pitch = (size_t)w * 3;
  // the band's output bytes as a tile in shared memory, at the offset
  // modulo 16 they have in device memory: 16-byte loads for 16-byte stores
  uint8_t* tile = smem + ((uintptr_t)o0 & 15);
  uint8_t* work = smem + tile_bytes;
  // stage the rows' spans
  const uint8_t* first = img + ((size_t)(cy + r0) * w + cx) * 3;
  if (threadIdx.x < nr)
    s_lead[threadIdx.x] =
        (int)((uintptr_t)(first + (size_t)threadIdx.x * pitch) & 15);
  stage_spans(work, span, nr, first, pitch, L, lo, hi);
  cp_async_wait_all();
  __syncthreads();
  if (!mirror) {
    // each 16 output bytes straight from the spans (as five words
    // where they lie in one row)
    auto at = [&](unsigned li) {
      unsigned i = li / (unsigned)L, rem = li - i * (unsigned)L;
      return work + (size_t)i * span + s_lead[i] + rem;
    };
    store_band(
        o0, nbytes,
        [&](unsigned li) {
          unsigned i = li / (unsigned)L, rem = li - i * (unsigned)L;
          uint4 v;
          if (rem + 16 <= (unsigned)L) {
            uintptr_t p = (uintptr_t)(work + (size_t)i * span +
                                      s_lead[i] + rem);
            const uint32_t* q = (const uint32_t*)(p & ~(uintptr_t)3);
            unsigned sh8 = (unsigned)(p & 3) * 8;
            uint32_t w0 = q[0], w1 = q[1], w2 = q[2], w3 = q[3], w4 = q[4];
            v.x = __funnelshift_r(w0, w1, sh8);
            v.y = __funnelshift_r(w1, w2, sh8);
            v.z = __funnelshift_r(w2, w3, sh8);
            v.w = __funnelshift_r(w3, w4, sh8);
          } else {
            // across a row's end (rare): byte by byte
            alignas(16) uint8_t b16[16];
#pragma unroll 1
            for (int k = 0; k < 16; ++k) b16[k] = *at(li + k);
            v = *reinterpret_cast<const uint4*>(b16);
          }
          return v;
        },
        [&](unsigned li) { return *at(li); });
    return;
  }
  // mirrored: reverse the pixels into the tile, then store from it
  each_pixel(0, nr, W, [&](int i, int x) {
    const uint8_t* s = work + (size_t)i * span + s_lead[i] + 3 * (W - 1 - x);
    uint8_t* d = tile + (size_t)i * L + 3 * x;
    d[0] = s[0];
    d[1] = s[1];
    d[2] = s[2];
  });
  __syncthreads();
  store_band(
      o0, nbytes,
      [&](unsigned li) { return *reinterpret_cast<const uint4*>(tile + li); },
      [&](unsigned li) { return tile[li]; });
}


// The images with a resize or a DCT scale; a block on another image
// returns at once.
__global__ void __launch_bounds__(kThreads, kScaledBlocks)
    scaled_kernel(const uint8_t* __restrict__ src, long long src_bytes,
                  const int64_t* __restrict__ plan, int n_bands, int rows,
                  int H, int W, int tile_bytes, int stage_bytes,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long s_plan[kPlan];
  __shared__ int s_y0[kBand];
  __shared__ float s_wy[kBand];
  __shared__ int s_row0[kBand], s_row1[kBand];
  const int n = blockIdx.x / n_bands;
  const int r0 = (blockIdx.x - n * n_bands) * rows;
  const int nr = min(rows, H - r0);
  const Plan P = read_plan(src, plan, n, s_plan);
  if (P.copies()) return;
  const uint8_t* img = P.img;
  const int w = P.w, h = P.h, denom = P.denom, sw = P.sw, sh = P.sh;
  const int tw = P.tw, th = P.th, cy = P.cy, cx = P.cx, mirror = P.mirror;
  const int L = W * 3;
  const uintptr_t lo = (uintptr_t)src, hi = lo + (uintptr_t)src_bytes;
  uint8_t* o0 = out + ((size_t)n * H + r0) * L;
  const size_t nbytes = (size_t)nr * L;
  const size_t pitch = (size_t)w * 3;
  uint8_t* tile = smem + ((uintptr_t)o0 & 15);
  uint8_t* work = smem + tile_bytes;
  // the taps of the band's rows and columns
  const bool identity = tw == sw && th == sh;
  const bool table = W <= kTableMax;
  int* t_x0 = reinterpret_cast<int*>(work);
  float* t_wx = reinterpret_cast<float*>(work + (size_t)4 * W);
  uint8_t* st = work + (table ? (((size_t)8 * W + 15) & ~(size_t)15) : 0);
  if (threadIdx.x < nr) {
    int oy = cy + r0 + threadIdx.x;
    if (identity) {
      s_y0[threadIdx.x] = oy;
      s_wy[threadIdx.x] = 0;
    } else {
      tap(oy, sh, th, &s_y0[threadIdx.x], &s_wy[threadIdx.x]);
    }
  }
  if (table) {
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      int ox = cx + (mirror ? W - 1 - x : x);
      if (identity) {
        t_x0[x] = ox;
        t_wx[x] = 0;
      } else {
        tap(ox, sw, tw, &t_x0[x], &t_wx[x]);
      }
    }
  }
  __syncthreads();
  // the scaled columns the band reads (the taps are monotone)
  int xa, xb;
  if (identity) {
    xa = cx;
    xb = cx + W - 1;
  } else {
    float unused;
    tap(cx, sw, tw, &xa, &unused);
    tap(cx + W - 1, sw, tw, &xb, &unused);
    xb = xb + 1 < sw ? xb + 1 : sw - 1;
  }
  const int ncols = xb - xa + 1;
  const int stride = denom == 1 ? ((ncols * 3 + 30) / 16) * 16 : ncols * 3;
  // the band's rows in chunks whose scaled rows fit the stage
  for (int c0 = 0, c1 = nr; c0 < nr; c0 = c1, c1 = nr) {
    int ya = s_y0[c0], yb;
    for (;;) {
      yb = identity ? s_y0[c1 - 1]
                    : (s_y0[c1 - 1] + 1 < sh ? s_y0[c1 - 1] + 1 : sh - 1);
      if ((size_t)(yb - ya + 1) * stride <= (size_t)stage_bytes ||
          c1 - c0 == 1)
        break;
      c1 = c0 + (c1 - c0) / 2;
    }
    const int ny = yb - ya + 1;
    const bool staged =
        table && (size_t)ny * stride <= (size_t)stage_bytes;
    const uintptr_t first = (uintptr_t)(img + ((size_t)ya * w + xa) * 3);
    // staged row k's bytes from column xa on, as an offset into the stage
    auto staged_row = [&](int k) {
      int lead = denom == 1 ? (int)((first + (size_t)k * pitch) & 15) : 0;
      return k * stride + lead;
    };
    if (staged) {
      if (denom == 1) {
        stage_spans(st, stride, ny, (const uint8_t*)first, pitch, ncols * 3,
                    lo, hi);
        cp_async_wait_all();
      } else {
        // block means, once each
        const int per_row = ncols * 3;
        for (int e = threadIdx.x; e < ny * per_row; e += blockDim.x) {
          int i = e / per_row, r = e - i * per_row;
          int j = r / 3, c = r - 3 * j;
          st[e] = block_mean(img, w, h, denom, ya + i, xa + j, c);
        }
      }
    }
    if (!staged) {
      each_pixel(c0, c1, W, [&](int i, int x) {
        direct_pixel(img, w, h, denom, sw, sh, tw, identity, table, t_x0,
                     t_wx, cx + (mirror ? W - 1 - x : x), x, s_y0[i],
                     s_wy[i], tile + (size_t)i * L + 3 * x);
      });
    } else {
      // each band row's two staged rows, as offsets into the stage
      if ((int)threadIdx.x < c1 - c0) {
        const int i = c0 + threadIdx.x, y0 = s_y0[i];
        const int y1 = identity ? y0 : (y0 + 1 < sh ? y0 + 1 : sh - 1);
        s_row0[i] = staged_row(y0 - ya);
        s_row1[i] = staged_row(y1 - ya);
      }
      __syncthreads();
      each_pixel(c0, c1, W, [&](int i, int x) {
        const int x0 = t_x0[x];
        const float wx = t_wx[x];
        const uint8_t* p0 = st + s_row0[i] + (x0 - xa) * 3;
        uint8_t* d = tile + (size_t)i * L + 3 * x;
        if (identity) {
          d[0] = p0[0];
          d[1] = p0[1];
          d[2] = p0[2];
          return;
        }
        const uint8_t* p1 = st + s_row1[i] + (x0 - xa) * 3;
        const int dx = x0 + 1 < sw ? 3 : 0;
        const float wy = s_wy[i];
        const float ay = __fsub_rn(1.0f, wy), ax = __fsub_rn(1.0f, wx);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float v = __fmul_rn(__fmul_rn((float)p0[c], ay), ax);
          v = __fadd_rn(v, __fmul_rn(__fmul_rn((float)p0[dx + c], ay), wx));
          v = __fadd_rn(v, __fmul_rn(__fmul_rn((float)p1[c], wy), ax));
          v = __fadd_rn(v, __fmul_rn(__fmul_rn((float)p1[dx + c], wy), wx));
          d[c] = (uint8_t)__float2uint_rz(__fadd_rn(v, 0.5f));
        }
      });
    }
    __syncthreads();  // the stage is read before the next chunk's copy
  }
  store_band(
      o0, nbytes,
      [&](unsigned li) { return *reinterpret_cast<const uint4*>(tile + li); },
      [&](unsigned li) { return tile[li]; });
}

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int batch = -1;
  int threads = -1;
};

}  // namespace

extern "C" {

// A decoder (nvJPEG handle and state) for one host thread; null on error,
// with the nvJPEG status in *status.
void* mxtt_njp_create(int* status) {
  Decoder* d = new Decoder();
  int st = nvjpegCreateSimple(&d->handle);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegJpegStateCreate(d->handle, &d->state);
  *status = st;
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (d->handle) nvjpegDestroy(d->handle);
    delete d;
    return nullptr;
  }
  return d;
}

void mxtt_njp_destroy(void* p) {
  Decoder* d = static_cast<Decoder*>(p);
  if (!d) return;
  nvjpegJpegStateDestroy(d->state);
  nvjpegDestroy(d->handle);
  delete d;
}

// The full-size width and height of one JPEG (nvJPEG status returned).
int mxtt_njp_info(void* p, const uint8_t* data, int64_t len, int* w,
                  int* h) {
  Decoder* d = static_cast<Decoder*>(p);
  int nc = 0;
  nvjpegChromaSubsampling_t ss;
  int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
  int st = nvjpegGetImageInfo(d->handle, data, (size_t)len, &nc, &ss, ws,
                              hs);
  *w = ws[0];
  *h = hs[0];
  return st;
}

// Decode n JPEGs (blob + offs[i], lens[i] bytes) to interleaved RGB at
// dev + dev_offs[i], rows of widths[i] * 3 bytes, on `stream`.
int mxtt_njp_decode(void* p, const uint8_t* blob, const int64_t* offs,
                    const int64_t* lens, int n, uint8_t* dev,
                    const int64_t* dev_offs, const int32_t* widths,
                    int threads, cudaStream_t stream) {
  Decoder* d = static_cast<Decoder*>(p);
  if (d->batch != n || d->threads != threads) {
    int st = nvjpegDecodeBatchedInitialize(d->handle, d->state, n, threads,
                                           NVJPEG_OUTPUT_RGBI);
    if (st != NVJPEG_STATUS_SUCCESS) return st;
    d->batch = n;
    d->threads = threads;
  }
  std::vector<const unsigned char*> data(n);
  std::vector<size_t> sizes(n);
  std::vector<nvjpegImage_t> imgs(n);
  for (int i = 0; i < n; ++i) {
    data[i] = blob + offs[i];
    sizes[i] = (size_t)lens[i];
    memset(&imgs[i], 0, sizeof(nvjpegImage_t));
    imgs[i].channel[0] = dev + dev_offs[i];
    imgs[i].pitch[0] = (unsigned int)widths[i] * 3;
  }
  return nvjpegDecodeBatched(d->handle, d->state, data.data(), sizes.data(),
                             imgs.data(), stream);
}

// The crop kernels over n decoded images packed in src (src_bytes long):
// out (n, H, W, 3) uint8, bands of up to kBand output rows a block
// (fewer where wide rows would not fit 48 KB of shared memory).
// `kinds` says which images the plan holds: bit 0 those with no resize
// at scale 1 (copy_kernel), bit 1 the others (scaled_kernel); each kernel
// whose bit is set is launched over every band of every image.
int mxtt_jpeg_crop(const uint8_t* src, int64_t src_bytes,
                   const int64_t* plan, int n, int H, int W, int kinds,
                   uint8_t* out, cudaStream_t stream) {
  if (n <= 0 || H <= 0 || W <= 0 || kinds < 1 || kinds > 3)
    return (int)cudaErrorInvalidValue;
  const size_t L = (size_t)W * 3;
  // a row's 16-byte-aligned enclosing run: at most (L + 30) / 16 chunks
  const size_t span = (L + 30) / 16 * 16;
  size_t r = kBand;
  while (r > 1 && r * (span + L) > 48 * 1024) --r;
  const long long bands = (H + (long long)r - 1) / (long long)r;
  if (bands * n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(bands * n);
  const size_t tile = (r * L + 16 + 15) / 16 * 16;
  if (kinds & 1) {
    const size_t smem = tile + r * span + 16;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    copy_kernel<<<grid, kThreads, smem, stream>>>(
        src, (long long)src_bytes, plan, (int)bands, (int)r, H, W, (int)tile,
        (int)span, out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (kinds & 2) {
    const size_t table = W <= kTableMax ? ((size_t)8 * W + 15) / 16 * 16 : 0;
    const size_t smem = tile + table + kStage;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          scaled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    scaled_kernel<<<grid, kThreads, smem, stream>>>(
        src, (long long)src_bytes, plan, (int)bands, (int)r, H, W, (int)tile,
        kStage, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
