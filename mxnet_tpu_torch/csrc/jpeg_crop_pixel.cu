// The first design of the record pipeline's crop kernel, kept for
// comparisons: tools/profile_records.py times it in turns with
// csrc/jpeg_decode.cu's kernels in one process, and the card's tests hold
// those kernels bitwise to it. Nothing in the package launches it.
//
// One thread an output pixel of (n, H, W, 3), blocks of 128 threads over
// (W / 128, H, n): each thread reads its image's plan row (the layout of
// kernels/jpeg_decode.py, crop_plan), its taps and, at a DCT scale, each
// tap's block mean for each channel, and writes its pixel as three
// single-byte stores. The arithmetic is jpeg_decode.cu's, op by op.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

__global__ void pixel_kernel(const uint8_t* __restrict__ src,
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

}  // namespace

extern "C" {

// The first design over n decoded images: out (n, H, W, 3) uint8, one
// launch on `stream`.
int mxtt_jpeg_crop_pixel(const uint8_t* src, const int64_t* plan, int n,
                         int H, int W, uint8_t* out, cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((W + 127) / 128, H, n);
  pixel_kernel<<<grid, block, 0, stream>>>(src, plan, H, W, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
