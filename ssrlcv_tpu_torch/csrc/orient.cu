// K1: 36-bin gradient-orientation histogram per keypoint.
//
// Replaces the Pallas kernel ssrlcv_tpu/features/orient_kernel.py
// (_orient_kernel, wrapper orientation_histograms).  Plain version:
// ssrlcv_tpu_torch/features/orient_kernel.py::orientation_histograms_plain.
//
// For keypoint k with centre (cx, cy) = (rint(x), rint(y)) and window
// r = min(win_k, w_max), every integer offset |dx|,|dy| <= r samples the
// gradient plane at the clamped pixel (cy+dy, cx+dx) and adds
//   weight = |g| * exp(-(dx^2+dy^2) / denom_k)
// to bin clip(floor(mod(atan2(gy,gx) + 2pi, 2pi) * 18/pi), 0, 35).
//
// What bounds it on the H100: at the main path's shapes (a 2048^2 plane,
// ~8k keypoints, windows up to 45^2) the work is ~16M samples: a few tens
// of MB of scattered 4-byte reads that mostly hit L1/L2 (neighbouring
// keypoints share rows), and an atan2f + expf per sample.  It is latency
// bound, not bandwidth bound.
//
// Design: one block per keypoint (no cross-block reduction).  Phase 1: the
// block's threads compute each window sample's (weight, bin) into shared
// memory.  Phase 2: thread b sums the weights of bin b in fixed row-major
// sample order -- deterministic, no float atomics.  The TPU kernel's patch
// DMAs, KB=8 keypoint groups and (8,128) alignment are gone: a block reads
// its samples straight from device memory through the cache.
//
// Parity with the plain version:
//  * rounding of the centre is rint (half to even), as torch.round;
//  * the angle uses floor-mod (torch.remainder / jnp.mod), not C fmodf,
//    and its bin is floor(angle * float(18/pi)) on both sides (a product,
//    so no device is free to turn a division into a reciprocal product);
//  * atan2f may differ from the CPU's atan2 in the last ulps, which moves a
//    sample only when it lies exactly on a bin edge;
//  * the magnitude is sqrt of separately rounded products and sum (no FMA);
//  * sums run in another order than torch.sum, so histograms agree to
//    float32 rounding, not bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void orient_hist_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                                   int h, int w, const float* __restrict__ loc,
                                   const float* __restrict__ win, const float* __restrict__ denom,
                                   int w_max, float* __restrict__ hist) {
  extern __shared__ float smem[];
  const int side_max = 2 * w_max + 1;
  float* s_w = smem;                                             // side_max^2 weights
  unsigned char* s_bin = reinterpret_cast<unsigned char*>(smem + side_max * side_max);

  const int k = blockIdx.x;
  const float wk = win[k];
  // keypoints whose window is NaN or negative contribute nothing
  const int r = (wk >= 0.0f) ? static_cast<int>(fminf(wk, static_cast<float>(w_max))) : -1;
  const int side = 2 * r + 1;
  const int n = r >= 0 ? side * side : 0;
  const int cx = __float2int_rn(loc[2 * k]);
  const int cy = __float2int_rn(loc[2 * k + 1]);
  const float dn = denom[k];
  const float two_pi = static_cast<float>(2.0 * SSRLCV_PI);
  const float inv_rad10 = static_cast<float>(18.0 / SSRLCV_PI);

  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int dy = s / side - r;
    const int dx = s % side - r;
    const int xi = clampi(cx + dx, 0, w - 1);
    const int yi = clampi(cy + dy, 0, h - 1);
    const float vx = gx[static_cast<size_t>(yi) * w + xi];
    const float vy = gy[static_cast<size_t>(yi) * w + xi];
    const float d2 = static_cast<float>(dx * dx + dy * dy);
    const float wt = __fmul_rn(mag_rn(vx, vy), expf(__fdiv_rn(-d2, dn)));
    const float ang = floor_mod(__fadd_rn(atan2f(vy, vx), two_pi), two_pi);
    float b = floorf(__fmul_rn(ang, inv_rad10));
    b = fminf(fmaxf(b, 0.0f), 35.0f);
    s_w[s] = wt;
    s_bin[s] = static_cast<unsigned char>(b);
  }
  __syncthreads();

  if (threadIdx.x < 36) {
    const unsigned char mine = static_cast<unsigned char>(threadIdx.x);
    float acc = 0.0f;
    for (int s = 0; s < n; ++s) {
      if (s_bin[s] == mine) acc += s_w[s];
    }
    hist[static_cast<size_t>(k) * 36 + threadIdx.x] = acc;
  }
}

}  // namespace

extern "C" int ssrlcv_orient_hist(const void* gx, const void* gy, int h, int w, const void* loc,
                                  const void* win, const void* denom, int k, int w_max,
                                  void* hist, void* stream) {
  if (k == 0) return 0;
  const int side = 2 * w_max + 1;
  const size_t smem = static_cast<size_t>(side) * side * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(orient_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  orient_hist_kernel<<<k, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gx), static_cast<const float*>(gy), h, w,
      static_cast<const float*>(loc), static_cast<const float*>(win),
      static_cast<const float*>(denom), w_max, static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}
