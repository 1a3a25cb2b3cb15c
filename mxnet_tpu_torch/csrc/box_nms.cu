// Greedy non-maximum suppression sweep (N1) over score-sorted boxes.
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
// once and the mask written once, a few hundred KB at SSD300's
// (32, 8732): under a microsecond at 3.35 TB/s; the IoU tests (about 14
// flops each, only those the greedy order needs) are microseconds at the
// fp32 rate. What the sweep cannot avoid is its chain of dependent
// steps: row i's fate is known only after every kept row before it has
// been swept, so each kept row costs one block barrier.
//
// Design (simple and right first; an IoU-bitmask variant that computes
// the pairs in parallel and leaves one sequential OR-reduce is a later
// redesign):
//   - one 256-thread block per image; the keep flags live in shared
//     memory, and so do the L boxes and ids when they fit (SSD300:
//     183 KB of the 227 KB), else they are read from device memory;
//   - for each row i whose flag is still set, the block's threads test
//     the later rows j that are still kept (a cleared row needs no
//     test), then meet at a barrier; a row whose flag is clear costs one
//     shared-memory read and no barrier: no thread writes in such a step
//     and every thread reads the same flag, so the branch is uniform.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float corner_iou(float4 a, float4 b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f),
                                 fmaxf(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                                 fmaxf(__fsub_rn(b.w, b.y), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// kStaged: the L boxes and ids are copied into shared memory first
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
nms_sweep(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
          const float* __restrict__ ids, uint8_t* __restrict__ keep, int N,
          int L, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t row0 = static_cast<size_t>(blockIdx.x) * N;
  boxes += row0;
  valid += row0;
  keep += row0;
  if (ids != nullptr) ids += row0;
  const int flag_bytes = (L + 15) & ~15;
  uint8_t* s_keep = smem;
  float4* s_box = reinterpret_cast<float4*>(smem + flag_bytes);
  float* s_id = reinterpret_cast<float*>(smem + flag_bytes +
                                         static_cast<size_t>(L) * 16);
  const float4* box = kStaged ? s_box : boxes;
  const float* id = kStaged ? s_id : ids;

  for (int j = threadIdx.x; j < L; j += kThreads) {
    s_keep[j] = valid[j] ? 1 : 0;
    if (kStaged) {
      s_box[j] = boxes[j];
      if (ids != nullptr) s_id[j] = ids[j];
    }
  }
  __syncthreads();

  for (int i = 0; i < L; ++i) {
    if (!s_keep[i]) continue;  // the same value in every thread
    const float4 bi = box[i];
    const float ci = ids != nullptr ? id[i] : 0.f;
    for (int j = i + 1 + threadIdx.x; j < L; j += kThreads) {
      if (!s_keep[j]) continue;
      float o = corner_iou(bi, box[j]);
      if (ids != nullptr && id[j] != ci) o = 0.f;
      if (o > thresh) s_keep[j] = 0;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < N; j += kThreads) {
    keep[j] = j < L ? s_keep[j] : 0;
  }
}

template <bool kStaged>
cudaError_t launch(const void* boxes, const void* valid, const void* ids,
                   void* keep, int B, int N, int L, float thresh,
                   size_t smem, int optin, cudaStream_t stream) {
  // above 48 KB only after raising the kernel's limit (once a process)
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_sweep<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  nms_sweep<kStaged><<<B, kThreads, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(ids), static_cast<uint8_t*>(keep), N, L,
      thresh);
  return cudaGetLastError();
}

}  // namespace

// boxes (B, N, 4) float32 corner boxes in score order, valid (B, N) bool,
// ids (B, N) float32 class ids or null (class-blind), keep (B, N) bool
// out; all contiguous, 16-byte aligned, on the current device. Launches
// on `stream` without synchronizing. Returns a cudaError_t (0: launched);
// cudaErrorInvalidValue when not even the L flags fit in shared memory.
extern "C" int mxtt_box_nms(const void* boxes, const void* valid,
                            const void* ids, void* keep, int B, int N, int L,
                            float thresh, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t flags =
      (static_cast<size_t>(L) + 15) & ~static_cast<size_t>(15);
  const size_t staged = flags + static_cast<size_t>(L) * 16 +
                        (ids != nullptr ? static_cast<size_t>(L) * 4 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged <= static_cast<size_t>(optin)) {
    return launch<true>(boxes, valid, ids, keep, B, N, L, thresh, staged,
                        optin, s);
  }
  if (flags <= static_cast<size_t>(optin)) {
    return launch<false>(boxes, valid, ids, keep, B, N, L, thresh, flags,
                         optin, s);
  }
  return cudaErrorInvalidValue;
}
