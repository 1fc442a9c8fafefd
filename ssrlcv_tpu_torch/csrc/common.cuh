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
