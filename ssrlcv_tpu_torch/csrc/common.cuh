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

// floor-mod with the sign of the divisor (torch.remainder / jnp.mod).  For
// b > 0 and 0 <= a < 2b the result is a or a - b, exact (Sterbenz), as
// fmodf's, without fmodf's loop; elsewhere fmodf.
__device__ __forceinline__ float floor_mod(float a, float b) {
  if (a >= 0.0f && a < 2.0f * b) return a < b ? a : __fsub_rn(a, b);
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

// ---- Fragment and copy helpers of the tensor-core matchers (K3 match.cu,
// K4 match_mma.cu) ----

// boxes (ylo, yhi, xlo, xhi): a query slots' band and a target tile's ranges
// (an empty tile has ylo > yhi and meets nothing)
__device__ __forceinline__ bool overlaps(float4 q, float4 t) {
  return t.x <= t.y && q.x <= t.y && q.y >= t.x && q.z <= t.w && q.w >= t.z;
}

// c += a * b on the tensor cores: m16n8k32, row-major A (16 x 32 bytes),
// column-major B (32 x 8 bytes), u8 x u8 -> s32, exact.  Register i of a
// holds, for thread lane (g = lane >> 2, tq = lane & 3): a[0] row g, bytes
// 4tq..4tq+3; a[1] row g+8, same bytes; a[2] row g, bytes 16+4tq..; a[3]
// row g+8, bytes 16+4tq..; b0 target g, bytes 4tq..; b1 target g, bytes
// 16+4tq..; accumulator c[0], c[1] row g, targets 2tq, 2tq+1; c[2], c[3]
// row g+8.
__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lexicographic (d, idx) minimum over the four threads of a quad (the
// threads that share an accumulator row): the lowest index wins a tie,
// whatever the order of the reduction.
__device__ __forceinline__ void quad_argmin(int& d, int& i) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const int od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (od < d || (od == d && oi < i)) {
      d = od;
      i = oi;
    }
  }
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
