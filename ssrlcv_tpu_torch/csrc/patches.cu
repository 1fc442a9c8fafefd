// K5: per-keypoint aligned gradient patches.
//
// Replaces the Pallas kernel ssrlcv_tpu/features/patches.py (_extract_kernel,
// called from extract_patches).  Plain version:
// ssrlcv_tpu_torch/features/patches.py::extract_patches_plain.
//
// For keypoint k with (cx, cy) = its location rounded half to even
// (__float2int_rn, as torch.round / jnp.round):
//   y0 = clip((cy - (w_max + 1)) & ~7, 0, H - SPA)
//   x0 = clip((cx - 64) & ~127, 0, W - 256)
//   px[k] = gx[y0 : y0 + SPA, x0 : x0 + 256], py[k] likewise.
// A pure copy: the output is bit-identical to the plain version.
//
// What bounds it on the H100: device-memory bandwidth.  Every keypoint reads
// and writes 2 x SPA x 256 floats (SPA = 56 / 72 at w_max = 22 / 29), about
// 8x the (2 w_max + 1)^2 window the samplers then use: the row and lane
// alignment slack is the TPU's DMA tile rule, kept because y0 / x0 are part
// of the output contract.  Dropping the slack changes that contract and is
// later work.
//
// Design: one block of 256 threads per keypoint.  With W % 4 == 0 and
// 16-byte aligned planes (then every x0 is a multiple of 4), each row is 64
// float4 loads and stores, four rows per pass, neighbouring threads on
// neighbouring addresses; otherwise each thread copies one float of a row.
// The wrapper picks the form from the plane's width and alignment.
#include "common.cuh"

namespace {

constexpr int kLW = 256;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_patches_kernel(const float* __restrict__ gx, const float* __restrict__ gy, int h, int w,
                       const float* __restrict__ loc, int w_max, int spa, int vec,
                       float* __restrict__ px, float* __restrict__ py, int* __restrict__ y0_out,
                       int* __restrict__ x0_out) {
  const int k = blockIdx.x;
  const int cx = __float2int_rn(loc[2 * k]);
  const int cy = __float2int_rn(loc[2 * k + 1]);
  const int y0 = clampi((cy - (w_max + 1)) & ~7, 0, h - spa);
  const int x0 = clampi((cx - 64) & ~127, 0, w - kLW);
  if (threadIdx.x == 0) {
    y0_out[k] = y0;
    x0_out[k] = x0;
  }
  const size_t base = static_cast<size_t>(y0) * w + x0;
  float* ox = px + static_cast<size_t>(k) * spa * kLW;
  float* oy = py + static_cast<size_t>(k) * spa * kLW;
  if (vec) {
    constexpr int kRow4 = kLW / 4;                 // float4 per patch row
    constexpr int kRowsPerPass = kThreads / kRow4;
    const int c4 = threadIdx.x % kRow4;
    for (int r = threadIdx.x / kRow4; r < spa; r += kRowsPerPass) {
      const size_t src = base + static_cast<size_t>(r) * w + 4 * c4;
      const float4 vx = *reinterpret_cast<const float4*>(gx + src);
      const float4 vy = *reinterpret_cast<const float4*>(gy + src);
      reinterpret_cast<float4*>(ox + r * kLW)[c4] = vx;
      reinterpret_cast<float4*>(oy + r * kLW)[c4] = vy;
    }
  } else {
    for (int r = 0; r < spa; ++r) {
      const size_t src = base + static_cast<size_t>(r) * w + threadIdx.x;
      ox[r * kLW + threadIdx.x] = gx[src];
      oy[r * kLW + threadIdx.x] = gy[src];
    }
  }
}

}  // namespace

extern "C" int ssrlcv_extract_patches(const void* gx, const void* gy, int h, int w,
                                      const void* loc, int k, int w_max, int spa, int vec,
                                      void* px, void* py, void* y0, void* x0, void* stream) {
  if (k == 0) return 0;
  extract_patches_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gx), static_cast<const float*>(gy), h, w,
      static_cast<const float*>(loc), w_max, spa, vec, static_cast<float*>(px),
      static_cast<float*>(py), static_cast<int*>(y0), static_cast<int*>(x0));
  return static_cast<int>(cudaGetLastError());
}
