// K2: raw 4x4x8 SIFT descriptor histogram per oriented keypoint.
//
// Replaces the Pallas kernel ssrlcv_tpu/features/desc_kernel.py
// (_desc_kernel, wrapper descriptor_histograms).  Plain version:
// ssrlcv_tpu_torch/features/desc_kernel.py::descriptor_histograms_plain,
// the gather form of ssrlcv_tpu/features/descriptor.py::fill_descriptors.
//
// For keypoint k (x, y, theta, window win = ceil(sigma*lambda_d/pw)) and
// each lattice offset |dx|,|dy| <= min(win, w_max):
//   (cx, cy) = R(theta) (dx, dy); the sample counts if |cx|,|cy| <= win;
//   it reads the gradient at the clamped pixel (rint(y+cy), rint(x+cx));
//   weight = |g| * exp(-(cx^2+cy^2) / (2 win^2))     (window width, not
//            sigma: a reference quirk)
//   angle  = fmodf(atan2(gy,gx) - theta + 2pi, 2pi)  (C trunc fmod: may be
//            negative, a reference quirk)
// and adds weight * spatial * angular to each of the 128 (cell, bin) sums:
// cell centres R(theta)((0.5i-0.75)win, (0.5j-0.75)win), spatial weight
// (1-|dcx|/binw)(1-|dcy|/binw) inside the cell (binw = win/2), angular
// weight max(0, 1-|angle-b*pi/4|/(pi/4)) with the distance NOT wrapped.
// The L2 normalise / clamp / uint8 epilogue stays in PyTorch.
//
// What bounds it on the H100: per keypoint up to (2*29+1)^2 = 3481
// samples, each feeding 128 (cell, bin) sums -- ~20 float ops per
// (sample, sum), about 9 MFLOP per keypoint and 70 GFLOP for 8k keypoints:
// FP32-ALU bound; the gradient reads are small and cache resident.
//
// Design: one block of 128 threads per keypoint.  Phase 1 computes each
// sample's (cx, cy, weight, angle) into shared memory (16 B per sample, so
// up to 55 KB at w_max = 29: dynamic shared memory above 48 KB).  Phase 2
// gives each thread one (cell, bin) and sums over the samples in fixed
// order -- deterministic, no float atomics.  The TPU kernel's patch DMAs,
// 128-lane row sweeps, lane interleave and KB=8 groups are gone.
//
// Parity with the plain version:
//  * sample coordinates round half to even (rint), as torch.round;
//  * the rotated offsets, the window tests and the cell distances use
//    separately rounded products and sums (no FMA), so a sample lands on
//    the same pixel and in the same cells as in the plain version;
//  * the angle uses C trunc fmodf (torch.fmod), unlike K1's floor-mod;
//  * 1/(pi/4) is applied as a product by float(4/pi) on both sides;
//  * atan2f may differ from the CPU's atan2 in the last ulps, and the sums
//    run in another order than the plain einsum: histograms agree to float
//    rounding, and uint8 descriptors to within a count or two.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // one thread per (cell, bin)

__global__ void desc_hist_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                                 int h, int w, const float* __restrict__ loc,
                                 const float* __restrict__ theta, const float* __restrict__ cost,
                                 const float* __restrict__ sint, const float* __restrict__ win,
                                 int w_max, float* __restrict__ hist) {
  extern __shared__ float4 s_samp[];  // (cx, cy, weight, angle) per sample

  const int k = blockIdx.x;
  const float wk = win[k];
  const int r = (wk >= 1.0f) ? static_cast<int>(fminf(wk, static_cast<float>(w_max))) : -1;
  const int side = 2 * r + 1;
  const int n = r >= 0 ? side * side : 0;
  const float lx = loc[2 * k];
  const float ly = loc[2 * k + 1];
  const float th = theta[k];
  const float ct = cost[k];
  const float st = sint[k];
  const float two_pi = static_cast<float>(2.0 * SSRLCV_PI);
  const float den = __fmul_rn(2.0f, __fmul_rn(wk, wk));

  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float dy = static_cast<float>(s / side - r);
    const float dx = static_cast<float>(s % side - r);
    const float cx = __fsub_rn(__fmul_rn(dx, ct), __fmul_rn(dy, st));
    const float cy = __fadd_rn(__fmul_rn(dx, st), __fmul_rn(dy, ct));
    const bool valid = fabsf(cx) <= wk && fabsf(cy) <= wk;
    float wt = 0.0f;
    float ang = 0.0f;
    if (valid) {
      const int xi = clampi(__float2int_rn(__fadd_rn(cx, lx)), 0, w - 1);
      const int yi = clampi(__float2int_rn(__fadd_rn(cy, ly)), 0, h - 1);
      const float vx = gx[static_cast<size_t>(yi) * w + xi];
      const float vy = gy[static_cast<size_t>(yi) * w + xi];
      const float r2 = __fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy));
      wt = __fmul_rn(mag_rn(vx, vy), expf(__fdiv_rn(-r2, den)));
      ang = fmodf(__fadd_rn(__fsub_rn(atan2f(vy, vx), th), two_pi), two_pi);
    }
    s_samp[s] = make_float4(cx, cy, wt, ang);
  }
  __syncthreads();

  if (r < 0) {
    hist[static_cast<size_t>(k) * 128 + threadIdx.x] = 0.0f;
    return;
  }
  const int c = threadIdx.x >> 3;  // cell c = ny*4 + nx
  const int b = threadIdx.x & 7;   // angle bin
  const float cell_x = 0.5f * static_cast<float>(c & 3) - 0.75f;
  const float cell_y = 0.5f * static_cast<float>(c >> 2) - 0.75f;
  const float hx0 = __fmul_rn(cell_x, wk);
  const float hy0 = __fmul_rn(cell_y, wk);
  const float hx = __fsub_rn(__fmul_rn(hx0, ct), __fmul_rn(hy0, st));
  const float hy = __fadd_rn(__fmul_rn(hx0, st), __fmul_rn(hy0, ct));
  const float binw = __fdiv_rn(wk, 2.0f);
  const float rad45 = static_cast<float>(SSRLCV_PI / 4.0);
  const float inv_rad45 = static_cast<float>(4.0 / SSRLCV_PI);
  const float kk = __fmul_rn(static_cast<float>(b), rad45);

  float acc = 0.0f;
  for (int s = 0; s < n; ++s) {
    const float4 v = s_samp[s];
    if (v.z == 0.0f) continue;  // outside the window or zero gradient: adds 0
    const float ddx = fabsf(__fsub_rn(hx, v.x));
    const float ddy = fabsf(__fsub_rn(hy, v.y));
    if (!(ddx <= binw && ddy <= binw)) continue;
    const float wx = __fsub_rn(1.0f, __fdiv_rn(ddx, binw));
    const float wy = __fsub_rn(1.0f, __fdiv_rn(ddy, binw));
    const float adist = fabsf(__fsub_rn(v.w, kk));
    if (!(adist < rad45)) continue;
    const float wang = __fsub_rn(1.0f, __fmul_rn(adist, inv_rad45));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), v.z), wang));
  }
  hist[static_cast<size_t>(k) * 128 + threadIdx.x] = acc;
}

}  // namespace

extern "C" int ssrlcv_desc_hist(const void* gx, const void* gy, int h, int w, const void* loc,
                                const void* theta, const void* cost, const void* sint,
                                const void* win, int k, int w_max, void* hist, void* stream) {
  if (k == 0) return 0;
  const int side = 2 * w_max + 1;
  const size_t smem = static_cast<size_t>(side) * side * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(desc_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  desc_hist_kernel<<<k, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gx), static_cast<const float*>(gy), h, w,
      static_cast<const float*>(loc), static_cast<const float*>(theta),
      static_cast<const float*>(cost), static_cast<const float*>(sint),
      static_cast<const float*>(win), w_max, static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}
