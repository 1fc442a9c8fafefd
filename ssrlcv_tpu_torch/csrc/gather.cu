// K6: per-keypoint patch row sums, the patch-gather micro-benchmark.
//
// Replaces the Pallas kernel of scripts/bench_gather2.py (strat_h's kernel:
// per-keypoint patch DMA, then sum(|p|) over the patch rows in the lane
// frame), the candidate shape behind the orientation and descriptor
// kernels' gather.  Plain version:
// ssrlcv_tpu_torch/bench/gather_patches.py::patch_row_sums_plain.
//
// For keypoint k on plane bi[k], with SPA = ((s + 7) / 8) * 8 + 8 and
//   y0 = clip((cy - s / 2) & ~7, 0, H - SPA), x0 = clip((cx - 64) & ~127, 0, W - 256):
//   out[k, l] = sum over r = 0 .. SPA-1, in that order, of
//               |plane[bi, y0 + r, x0 + l]|,   l = 0 .. 127,
// accumulated in float32 with fabsf.  The benchmark's plane carries packed
// f16 pairs read as float32 bit patterns, some of them denormal: the build
// keeps denormals (no fast-math), and the plain version adds the rows in
// the same order, so the result is bit-identical.
//
// What bounds it on the H100: device-memory reads, SPA x 128 x 4 bytes per
// keypoint (24.6 KB at s = 33), against one add per float; only the 128
// lanes the output needs are read, not the TPU's 256-lane DMA window.
//
// Design: one thread per (keypoint, output lane), 128 threads per keypoint,
// two keypoints per block; a warp reads 128 contiguous bytes of a row per
// step, and each thread walks the rows in order, so the sum order is fixed.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kLW = 256;
constexpr int kKeysPerBlock = 2;

__global__ void __launch_bounds__(kLanes * kKeysPerBlock)
patch_row_sums_kernel(const float* __restrict__ plane, int h, int w,
                      const int* __restrict__ bi, const int* __restrict__ cy,
                      const int* __restrict__ cx, int k, int s, float* __restrict__ out) {
  const int key = blockIdx.x * kKeysPerBlock + threadIdx.x / kLanes;
  if (key >= k) return;
  const int lane = threadIdx.x % kLanes;
  const int spa = ((s + 7) / 8) * 8 + 8;
  const int y0 = clampi((cy[key] - s / 2) & ~7, 0, h - spa);
  const int x0 = clampi((cx[key] - kLanes / 2) & ~127, 0, w - kLW);
  const float* p = plane + (static_cast<size_t>(bi[key]) * h + y0) * w + x0 + lane;
  float acc = 0.0f;
  for (int r = 0; r < spa; ++r) acc = __fadd_rn(acc, fabsf(p[static_cast<size_t>(r) * w]));
  out[static_cast<size_t>(key) * kLanes + lane] = acc;
}

}  // namespace

extern "C" int ssrlcv_patch_row_sums(const void* plane, int h, int w, const void* bi,
                                     const void* cy, const void* cx, int k, int s, void* out,
                                     void* stream) {
  if (k == 0) return 0;
  const int blocks = (k + kKeysPerBlock - 1) / kKeysPerBlock;
  patch_row_sums_kernel<<<blocks, kLanes * kKeysPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), h, w, static_cast<const int*>(bi),
      static_cast<const int*>(cy), static_cast<const int*>(cx), k, s, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
