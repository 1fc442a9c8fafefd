// K1: 36-bin gradient-orientation histogram per keypoint.
//
// Replaces the Pallas kernel ssrlcv_tpu/features/orient_kernel.py
// (_orient_kernel, wrapper orientation_histograms).  Plain version:
// ssrlcv_tpu_torch/features/orient_kernel.py::orientation_histograms_plain;
// orientation_histograms_lanes there restates this kernel's summation order.
//
// For keypoint k with centre (cx, cy) = (rint(x), rint(y)) and window
// r = min(win_k, w_max), every integer offset |dx|,|dy| <= r samples the
// gradient plane at the clamped pixel (cy+dy, cx+dx) and adds
//   weight = |g| * exp(-(dx^2+dy^2) / denom_k)
// to bin clip(floor(mod(atan2(gy,gx) + 2pi, 2pi) * 18/pi), 0, 35).
//
// What bounds it on the H100: the bytes.  Each input read once and each
// output written once -- the two gradient planes (2 x 16 MB at octave 0 of a
// 1024^2 image, for each of the three blur buckets), the keypoints and their
// histograms -- take ~0.03 ms at 3.35 TB/s; the ~40 fp32 operations of each
// window sample take less at 67 TFLOP/s (chip_smoke.py computes both).
//
// What held the first design back: one 128-thread block per keypoint; after
// every sample's (weight, bin) was written to shared memory, 36 threads each
// walked all n <= (2 w_max + 1)^2 samples of the window and kept those of
// their own bin.  Every sample was read 36 times, about 10 warp-instructions
// per sample against about 2 for computing it, while 92 threads idled.
//
// Design: one warp per keypoint, 8 keypoints a block.  Lane l takes samples
// l, l+32, ... in row-major order, so neighbouring lanes read neighbouring
// pixels of a row.  Each sample's weight and bin are computed once, in
// registers, and added once into the lane's own 36-bin histogram in shared
// memory, laid out [bin][lane] so that lane l always hits bank l (4.6 KB a
// warp; no atomics).  At the end lane j < 18 sums bins j and j+18 over the
// 32 lanes in a fixed order, starting at lane j (the 18 reads of a step hit
// 18 banks): the result is the same on every run.  The window and the
// Gaussian denominator are computed per keypoint from sigma in the kernel,
// so that a call is one launch, and the floor-mod of the angle takes no
// fmodf (floor_mod, common.cuh).
//
// Parity with the plain version:
//  * rounding of the centre is rint (half to even), as torch.round;
//  * window_and_denom's window and denominator, each product and quotient
//    rounded to float32 in its order, as torch rounds a float32 tensor times
//    a Python float;
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

constexpr int kWarps = 8;  // keypoints per block, one warp each
constexpr int kBins = 36;

__global__ void __launch_bounds__(kWarps * 32)
orient_hist_kernel(const float* __restrict__ gx, const float* __restrict__ gy, int h, int w,
                   const float* __restrict__ loc, const float* __restrict__ sigma, int nk,
                   int w_max, float pixel_width, float lambda_o, float two_lambda_sq,
                   float* __restrict__ hist) {
  __shared__ float s_hist[kWarps][kBins * 32];  // per warp: [bin][lane] partial sums
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= nk) return;  // a whole warp: no block-wide barrier follows
  float* hw = s_hist[threadIdx.x >> 5];
#pragma unroll
  for (int b = 0; b < kBins; ++b) hw[b * 32 + lane] = 0.0f;

  // window_and_denom's window ceil(sigma * 3 * lambda / pw) and Gaussian
  // denominator (2 lambda^2) * sigma * sigma, rounded as torch rounds them
  const float sk = sigma[k];
  const float wk = ceilf(__fdiv_rn(__fmul_rn(__fmul_rn(sk, 3.0f), lambda_o), pixel_width));
  const float dn = __fmul_rn(__fmul_rn(two_lambda_sq, sk), sk);
  // keypoints whose window is NaN or negative contribute nothing
  const int r = (wk >= 0.0f) ? static_cast<int>(fminf(wk, static_cast<float>(w_max))) : -1;
  const int side = 2 * r + 1;
  const int n = r >= 0 ? side * side : 0;
  const int cx = __float2int_rn(loc[2 * k]);
  const int cy = __float2int_rn(loc[2 * k + 1]);
  const float two_pi = static_cast<float>(2.0 * SSRLCV_PI);
  const float inv_rad10 = static_cast<float>(18.0 / SSRLCV_PI);

  // sample s = lane + 32 i sits at (dy, dx) = (s / side - r, s % side - r);
  // stepping s by 32 moves dx by 32 % side and dy by 32 / side, plus a carry
  const int step_y = 32 / side, step_x = 32 % side;
  int dy = lane / side - r, dx = lane % side - r;
#pragma unroll 2
  for (int s = lane; s < n; s += 32) {
    const int xi = clampi(cx + dx, 0, w - 1);
    const int yi = clampi(cy + dy, 0, h - 1);
    const float vx = __ldg(gx + static_cast<size_t>(yi) * w + xi);
    const float vy = __ldg(gy + static_cast<size_t>(yi) * w + xi);
    const float d2 = static_cast<float>(dx * dx + dy * dy);
    const float wt = __fmul_rn(mag_rn(vx, vy), expf(__fdiv_rn(-d2, dn)));
    const float ang = floor_mod(__fadd_rn(atan2f(vy, vx), two_pi), two_pi);
    float b = floorf(__fmul_rn(ang, inv_rad10));
    b = fminf(fmaxf(b, 0.0f), 35.0f);
    float* acc = hw + static_cast<int>(b) * 32 + lane;
    *acc = __fadd_rn(*acc, wt);
    dx += step_x;
    dy += step_y;
    if (dx > r) {
      dx -= side;
      ++dy;
    }
  }
  __syncwarp();

  // lane j < 18: bins j and j + 18, each summed over lanes j, j+1, ..., j+31
  // (mod 32) in that order
  if (lane < kBins / 2) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = lane + half * (kBins / 2);
      float acc = 0.0f;
      for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, hw[b * 32 + ((lane + i) & 31)]);
      hist[static_cast<size_t>(k) * kBins + b] = acc;
    }
  }
}

}  // namespace

extern "C" int ssrlcv_orient_hist(const void* gx, const void* gy, int h, int w, const void* loc,
                                  const void* sigma, int k, int w_max, float pixel_width,
                                  float lambda_o, float two_lambda_sq, void* hist,
                                  void* stream) {
  if (k == 0) return 0;
  orient_hist_kernel<<<(k + kWarps - 1) / kWarps, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gx), static_cast<const float*>(gy), h, w,
      static_cast<const float*>(loc), static_cast<const float*>(sigma), k, w_max, pixel_width,
      lambda_o, two_lambda_sq, static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}
