// Shared helpers for the ssrlcv_tpu_torch kernels.
//
// Parity rules that every kernel here follows (the plain PyTorch versions in
// the Python wrappers compute the same values with separate, individually
// rounded tensor operations):
//  * No contraction of a*b+c into a fused multiply-add where the result
//    feeds a comparison or a rounding decision: nvcc contracts by default,
//    so those expressions use __fmul_rn / __fadd_rn / __fsub_rn.
//  * Rounding to an integer is round-half-to-even (rintf / __float2int_rn),
//    as torch.round and jnp.round are; never roundf (half away from zero).
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#define SSRLCV_PI 3.14159265358979323846

// floor-mod with the sign of the divisor (torch.remainder / jnp.mod)
__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// sqrt(x*x + y*y) with both products and the sum rounded separately
__device__ __forceinline__ float mag_rn(float x, float y) {
  return sqrtf(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
}

// The epipolar-segment gate of the matching kernels (K3 match.cu, K4
// match_mma.cu); plain version: matching/match_kernel.py::
// epipolar_segment_mask.  A query with segment endpoints p1, p2 admits a
// target at (tx, ty) when
//   p1.x is not finite (unconstrained), or
//   left.x - e <= tx <= right.x + e (left/right: the endpoints ordered by x,
//   p1.x >= p2.x swaps) and
//     vertical (left.x == right.x): min(p1.y,p2.y) - e <= ty <= max(..) + e,
//     else |slope*(tx - left.x) + left.y - ty| <= e,
//          slope = (left.y - right.y) / (left.x - right.x).
// Every term is one separately rounded operation, as in the plain version:
// y_line is spelled with __fmul_rn/__fadd_rn because a fused multiply-add
// would move |y_line - ty| <= e at the boundary.
struct EpiGate {
  bool unconstrained, vertical;
  float lx, ly, x_lo, x_hi, y_lo, y_hi, slope, eps;
};

__device__ __forceinline__ EpiGate epi_gate(float p1x, float p1y, float p2x, float p2y,
                                            float eps) {
  EpiGate g;
  g.unconstrained = !isfinite(p1x);
  const bool swap = p1x >= p2x;
  g.lx = swap ? p2x : p1x;
  g.ly = swap ? p2y : p1y;
  const float rx = swap ? p1x : p2x, ry = swap ? p1y : p2y;
  g.x_lo = __fsub_rn(g.lx, eps);
  g.x_hi = __fadd_rn(rx, eps);
  g.vertical = g.lx == rx;
  g.y_lo = __fsub_rn(fminf(p1y, p2y), eps);
  g.y_hi = __fadd_rn(fmaxf(p1y, p2y), eps);
  const float dxs = __fsub_rn(g.lx, rx);
  g.slope = __fdiv_rn(__fsub_rn(g.ly, ry), dxs == 0.0f ? 1.0f : dxs);
  g.eps = eps;
  return g;
}

__device__ __forceinline__ bool epi_gate_pass(const EpiGate& g, float tx, float ty) {
  if (g.unconstrained) return true;
  if (!(tx >= g.x_lo && tx <= g.x_hi)) return false;
  if (g.vertical) return g.y_lo <= ty && g.y_hi >= ty;
  const float y_line = __fadd_rn(__fmul_rn(g.slope, __fsub_rn(tx, g.lx)), g.ly);
  return fabsf(__fsub_rn(y_line, ty)) <= g.eps;
}
