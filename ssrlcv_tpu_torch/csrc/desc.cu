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
// What bounds it on the H100: each sample contributes to about 4 cells (at
// most 5 with non-zero weight: the reference's cell test is an image-frame
// box around rotated centres; up to 9 at exact cell edges, with weight 0)
// and at most 2 bins.  Per sample about
// 40 operations of its own (rotation, rint, two gradient reads, magnitude,
// exp, atan2, fmod) and about 8 per (cell, bin) it feeds: octave 0 of a
// 1024^2 image (24.6k keypoints, windows 15/21/29) needs <= 8.5e7 samples x
// ~100 operations, about 0.13 ms at 67 TFLOP/s fp32; the gradient planes
// (~100 MB for three buckets) take 0.03 ms to read.  Operations bound it.
//
// What held the first design back: one 128-thread block per keypoint, one
// thread per (cell, bin), and every thread walked every sample of the
// window -- a given sample feeds at most 8 of the 128 threads, so >= 94 % of
// the visits added nothing; each visit was a serial, branchy step on one
// accumulator; and the per-sample buffer of the whole window (up to 55 KB)
// held an SM to 4 blocks of 4 warps.
//
// Design: one warp per keypoint, 4 keypoints per block.  The lanes take the
// window's samples in turn (lane l: samples l, l+32, ...), so each sample's
// terms are computed once, in registers.  A sample's cells come from the
// exact cell test against the 16 rotated centres (kept in registers), its
// bins from the exact bin test on the <= 4 bins around angle/(pi/4) (at
// most 2 pass), and only those (cell, bin) pairs are added -- into the
// lane's own 128-float histogram in shared memory, laid out [bin][lane] so
// that the 32 lanes always hit 32 banks.  At the end lane l sums bins l,
// l+32, l+64, l+96 over the 32 lanes in a fixed order.  No float atomics:
// the result is the same on every run.
//
// Parity with the plain version:
//  * sample coordinates round half to even (rint), as torch.round;
//  * the rotated offsets, the window tests and the cell distances use
//    separately rounded products and sums (no FMA), and the cell and bin
//    tests are the plain version's own comparisons on those values, applied
//    to every candidate, so a sample lands on the same pixel and in the same
//    cells and bins as in the plain version;
//  * the angle is C trunc fmod (torch.fmod), unlike K1's floor-mod,
//    computed exactly (trunc_mod_2pi);
//  * the spatial weights 1 - d/binw take d * (1/binw): within an ulp of
//    the plain version's quotient, and never part of a test;
//  * 1/(pi/4) is applied as a product by float(4/pi) on both sides;
//  * atan2f may differ from the CPU's atan2 in the last ulps, and the sums
//    run in another order than the plain einsum: histograms agree to float
//    rounding, and uint8 descriptors to within a count or two.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // keypoints per block, one warp each
constexpr int kBins = 128;
constexpr size_t kSmem = static_cast<size_t>(kWarps) * kBins * 32 * sizeof(float);

// fmodf(a, two_pi) (C trunc fmod, the sign of a), exact like fmodf: for
// 2pi <= |a| < 4pi the difference a -+ 2pi is exact (Sterbenz), below it a
// is its own remainder; beyond, fmodf itself
__device__ __forceinline__ float trunc_mod_2pi(float a, float two_pi) {
  const float m = fabsf(a);
  if (m < two_pi) return a;
  if (m < 2.0f * two_pi) return a > 0.0f ? __fsub_rn(a, two_pi) : __fadd_rn(a, two_pi);
  return fmodf(a, two_pi);
}

__global__ void __launch_bounds__(kWarps * 32)
desc_hist_kernel(const float* __restrict__ gx, const float* __restrict__ gy, int h, int w,
                 const float* __restrict__ loc, const float* __restrict__ theta,
                 const float* __restrict__ cost, const float* __restrict__ sint,
                 const float* __restrict__ win, int nk, int w_max, float* __restrict__ hist) {
  extern __shared__ float s_hist[];  // per warp: [bin][lane] partial sums
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= nk) return;  // a whole warp: no block-wide barrier follows
  float* hw = s_hist + static_cast<size_t>(threadIdx.x >> 5) * kBins * 32;
#pragma unroll 8
  for (int b = 0; b < kBins; ++b) hw[b * 32 + lane] = 0.0f;

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
  const float rad45 = static_cast<float>(SSRLCV_PI / 4.0);
  const float inv_rad45 = static_cast<float>(4.0 / SSRLCV_PI);
  const float den = __fmul_rn(2.0f, __fmul_rn(wk, wk));
  const float binw = __fdiv_rn(wk, 2.0f);
  const float inv_binw = __fdiv_rn(1.0f, binw);

  // rotated cell centres, c = ny*4 + nx
  float hx[16], hy[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float hx0 = __fmul_rn(0.5f * static_cast<float>(c & 3) - 0.75f, wk);
    const float hy0 = __fmul_rn(0.5f * static_cast<float>(c >> 2) - 0.75f, wk);
    hx[c] = __fsub_rn(__fmul_rn(hx0, ct), __fmul_rn(hy0, st));
    hy[c] = __fadd_rn(__fmul_rn(hx0, st), __fmul_rn(hy0, ct));
  }

  for (int s = lane; s < n; s += 32) {
    const float dy = static_cast<float>(s / side - r);
    const float dx = static_cast<float>(s % side - r);
    const float cx = __fsub_rn(__fmul_rn(dx, ct), __fmul_rn(dy, st));
    const float cy = __fadd_rn(__fmul_rn(dx, st), __fmul_rn(dy, ct));
    if (!(fabsf(cx) <= wk && fabsf(cy) <= wk)) continue;
    const int xi = clampi(__float2int_rn(__fadd_rn(cx, lx)), 0, w - 1);
    const int yi = clampi(__float2int_rn(__fadd_rn(cy, ly)), 0, h - 1);
    const float vx = __ldg(gx + static_cast<size_t>(yi) * w + xi);
    const float vy = __ldg(gy + static_cast<size_t>(yi) * w + xi);
    const float r2 = __fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy));
    const float wt = __fmul_rn(mag_rn(vx, vy), expf(__fdiv_rn(-r2, den)));
    if (wt == 0.0f) continue;  // adds 0 everywhere
    const float ang = trunc_mod_2pi(__fadd_rn(__fsub_rn(atan2f(vy, vx), th), two_pi), two_pi);

    // the bins b with |ang - b*pi/4| < pi/4: at most 2, among the 4 around
    // floor(ang * 4/pi) (the rounding of that guess moves it by at most 1)
    int b1 = -1, b2 = -1;
    float w1 = 0.0f, w2 = 0.0f;
    const int b0 = static_cast<int>(floorf(__fmul_rn(ang, inv_rad45)));
#pragma unroll
    for (int i = -1; i <= 2; ++i) {
      const int b = b0 + i;
      if (b < 0 || b > 7) continue;
      const float adist = fabsf(__fsub_rn(ang, __fmul_rn(static_cast<float>(b), rad45)));
      if (!(adist < rad45)) continue;
      const float wa = __fsub_rn(1.0f, __fmul_rn(adist, inv_rad45));
      if (b1 < 0) {
        b1 = b;
        w1 = wa;
      } else {
        b2 = b;
        w2 = wa;
      }
    }
    if (b1 < 0) continue;

#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float ddx = fabsf(__fsub_rn(hx[c], cx));
      const float ddy = fabsf(__fsub_rn(hy[c], cy));
      if (!(ddx <= binw && ddy <= binw)) continue;
      const float wx = __fsub_rn(1.0f, __fmul_rn(ddx, inv_binw));
      const float wy = __fsub_rn(1.0f, __fmul_rn(ddy, inv_binw));
      const float sw = __fmul_rn(__fmul_rn(wx, wy), wt);
      float* acc = hw + (c * 8 + b1) * 32 + lane;
      *acc = __fadd_rn(*acc, __fmul_rn(sw, w1));
      if (b2 >= 0) {
        acc = hw + (c * 8 + b2) * 32 + lane;
        *acc = __fadd_rn(*acc, __fmul_rn(sw, w2));
      }
    }
  }
  __syncwarp();

  // lane l: bins l, l+32, l+64, l+96, summed over the lanes in a fixed order
  // (starting at lane l, so that the 32 reads of a step hit 32 banks)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = q * 32 + lane;
    float acc = 0.0f;
    for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, hw[b * 32 + ((lane + i) & 31)]);
    hist[static_cast<size_t>(k) * kBins + b] = acc;
  }
}

}  // namespace

extern "C" int ssrlcv_desc_hist(const void* gx, const void* gy, int h, int w, const void* loc,
                                const void* theta, const void* cost, const void* sint,
                                const void* win, int k, int w_max, void* hist, void* stream) {
  if (k == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(desc_hist_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (k + kWarps - 1) / kWarps;
  desc_hist_kernel<<<blocks, kWarps * 32, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gx), static_cast<const float*>(gy), h, w,
      static_cast<const float*>(loc), static_cast<const float*>(theta),
      static_cast<const float*>(cost), static_cast<const float*>(sint),
      static_cast<const float*>(win), k, w_max, static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}
