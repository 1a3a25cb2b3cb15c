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
// Bound: bytes. Each output byte is written once and reads one source
// byte (no resize, the record pipeline's main path) or four to sixteen
// (a resize): about 2 x 19 MB for a batch of 128 at 224 x 224 from
// 252 x 252 images, some 10 us at the card's 3.35 TB/s. One thread an
// output pixel, its three channels in one pass, neighbouring threads on
// neighbouring pixels of a row.
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

__global__ void crop_kernel(const uint8_t* __restrict__ src,
                            const int64_t* __restrict__ plan, int H, int W,
                            uint8_t* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int n = blockIdx.z;
  if (x >= W) return;
  const int64_t* p = plan + (size_t)n * kPlan;
  const uint8_t* img = src + p[0];
  int w = (int)p[1], h = (int)p[2], denom = (int)p[3];
  int sw = (int)p[4], sh = (int)p[5], tw = (int)p[6], th = (int)p[7];
  int cy = (int)p[8], cx = (int)p[9], mirror = (int)p[10];
  int oy = cy + y;
  int ox = cx + (mirror ? W - 1 - x : x);
  uint8_t* dst = out + (((size_t)n * H + y) * W + x) * 3;
  if (tw == sw && th == sh) {
    for (int ch = 0; ch < 3; ++ch)
      dst[ch] = (uint8_t)scaled_px(img, w, h, denom, oy, ox, ch);
    return;
  }
  // decode_one's bilinear step: fy = (y + 0.5f) * sh / th - 0.5f
  float fy = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn((float)oy, 0.5f),
                                           (float)sh), (float)th), 0.5f);
  int y0 = fy < 0 ? 0 : (int)fy;
  int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
  float wy = __fsub_rn(fy, (float)y0);
  if (wy < 0) wy = 0;
  float fx = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn((float)ox, 0.5f),
                                           (float)sw), (float)tw), 0.5f);
  int x0 = fx < 0 ? 0 : (int)fx;
  int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
  float wx = __fsub_rn(fx, (float)x0);
  if (wx < 0) wx = 0;
  float ay = __fsub_rn(1.0f, wy), ax = __fsub_rn(1.0f, wx);
  for (int ch = 0; ch < 3; ++ch) {
    float v00 = scaled_px(img, w, h, denom, y0, x0, ch);
    float v01 = scaled_px(img, w, h, denom, y0, x1, ch);
    float v10 = scaled_px(img, w, h, denom, y1, x0, ch);
    float v11 = scaled_px(img, w, h, denom, y1, x1, ch);
    float v = __fmul_rn(__fmul_rn(v00, ay), ax);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, ay), wx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), ax));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
    dst[ch] = (uint8_t)__float2uint_rz(__fadd_rn(v, 0.5f));
  }
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

// The crop kernel over n decoded images: out (n, H, W, 3) uint8.
int mxtt_jpeg_crop(const uint8_t* src, const int64_t* plan, int n, int H,
                   int W, uint8_t* out, cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((W + 127) / 128, H, n);
  crop_kernel<<<grid, block, 0, stream>>>(src, plan, H, W, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
