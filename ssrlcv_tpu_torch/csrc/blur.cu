// Separable Gaussian blur with symmetric borders: the scale space's blur
// chain and the dense orientation field's 36 histogram planes.
//
// Replaces no TPU kernel: the JAX package leaves the blur to XLA
// (ssrlcv_tpu/ops/image_ops.py::convolve_separable_symmetric), which fuses
// the shifted multiply-adds.  Plain version:
// ssrlcv_tpu_torch/ops/image_ops.py::convolve_separable_symmetric_plain
// (a padded gather, then _fma_taps along W and again along H), which in
// eager PyTorch is three launches a tap: about 5,200 a SIFT call.
//
// Arithmetic, bit-identical to the plain version.  For each output pixel i
// of a line of length n (a row in the W pass, a column in the H pass):
//   acc = 0.0f
//   for t = 0 .. k-1, in this order:
//     acc = __double2float_rn((double)acc + (double)tap[t] * (double)x[src(i - half + t)])
// The product of two float32 values is exact in float64, so the fused
// multiply-add below rounds once, as the plain float64 add does.  The W
// pass writes float32 planes and the H pass reads them: the intermediate is
// rounded to float32, as in the plain version.  No tap is reordered or
// paired.
//
// Border, image_ops._symmetrize_coords: for a line of length n and a source
// index idx (any integer, so also where half >= n),
//   i = floor_mod(idx + 2n, 2n);  src = i > n-1 ? 2n-1-i : i.
//
// What bounds it on the H100: not the bytes.  A pass reads and writes each
// plane once: 2 x 16.8 MB at octave 0 (2048^2), 0.010 ms at 3.35 TB/s.  But
// every tap converts the accumulator to float64 and back, and the SM
// converts between float32 and float64 at 16 a clock: 2 x 65 conversions a
// pixel at 65 taps, ~0.15 ms for a 2048^2 pass on 132 SMs at 1.755 GHz.  The
// float64 multiply-adds (64 a clock) and the shared-memory reads hide under
// that.
//
// Design: each pass stages a tile plus its halo in shared memory once, with
// the symmetric wrap applied while staging, so the tap loop reads no index
// arithmetic and every plane element comes from device memory about once.
// Each thread computes kR = 8 consecutive outputs of one line with a
// sliding window of float64 inputs in registers: one shared load and one
// conversion a tap for all eight outputs, whose accumulators are eight
// independent chains.  The taps arrive as float64 in a __grid_constant__
// kernel parameter, read uniformly from the constant bank.
//  * W pass: 8 warps, one row each, 32 x 8 = 256 output columns a block.
//  * H pass: 32 columns (one a lane), 8 warps of 8 rows: 64 output rows a
//    block; the staged tile is (64 + k - 1) rows of 32 floats.
// Leading dimensions are independent planes (blockIdx.z, strided).
#include "common.cuh"

namespace {

constexpr int kMaxTaps = 255;   // image_ops.BLUR_MAX_TAPS
constexpr int kR = 8;           // outputs a thread, consecutive along the line
constexpr int kThreads = 256;   // 8 warps
constexpr int kTileW = 32 * kR; // W pass: output columns a block (one row a warp)
constexpr int kRowsW = kThreads / 32;
constexpr int kColsH = 32;      // H pass: output columns a block (one a lane)
constexpr int kTileH = (kThreads / 32) * kR;  // H pass: output rows a block
constexpr int kMaxPlanesZ = 65535;

struct Taps {
  double v[kMaxTaps];
};

// image_ops._symmetrize_coords for one index
__device__ __forceinline__ int symmetric(int idx, int n) {
  const int nn = 2 * n;
  int i = (idx + nn) % nn;
  if (i < 0) i += nn;
  return i > n - 1 ? nn - 1 - i : i;
}

// kR outputs of one line: out r = sum over t of taps[t] * s[(t + r) * stride],
// in tap order, each step one float64 fused multiply-add rounded to float32
__device__ __forceinline__ void tap_chain(const float* s, int stride, int k, const Taps& taps,
                                          float (&acc)[kR]) {
  double win[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int r = 1; r < kR; ++r) win[r] = static_cast<double>(s[(r - 1) * stride]);
  for (int t = 0; t < k; ++t) {
#pragma unroll
    for (int r = 0; r + 1 < kR; ++r) win[r] = win[r + 1];
    win[kR - 1] = static_cast<double>(s[(t + kR - 1) * stride]);
    const double tap = taps.v[t];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      acc[r] = __double2float_rn(fma(tap, win[r], static_cast<double>(acc[r])));
  }
}

__global__ void __launch_bounds__(kThreads)
blur_w_kernel(const float* __restrict__ x, float* __restrict__ y, int planes, int h, int w, int k,
              const __grid_constant__ Taps taps) {
  extern __shared__ float s[];  // kRowsW rows of pitch = kTileW + k - 1
  const int pitch = kTileW + k - 1;
  const int half = k / 2;
  const int c0 = blockIdx.x * kTileW;
  const int r0 = blockIdx.y * kRowsW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = r0 + warp, col = c0 + lane * kR;
  const size_t plane = static_cast<size_t>(h) * w;
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const float* xp = x + p * plane;
    for (int e = threadIdx.x; e < kRowsW * pitch; e += kThreads) {
      const int rr = e / pitch, j = e - rr * pitch;
      if (r0 + rr < h) s[e] = xp[static_cast<size_t>(r0 + rr) * w + symmetric(c0 - half + j, w)];
    }
    __syncthreads();
    if (row < h && col < w) {
      float acc[kR];
      tap_chain(s + warp * pitch + lane * kR, 1, k, taps, acc);
      float* yr = y + p * plane + static_cast<size_t>(row) * w;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (col + r < w) yr[col + r] = acc[r];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
blur_h_kernel(const float* __restrict__ x, float* __restrict__ y, int planes, int h, int w, int k,
              const __grid_constant__ Taps taps) {
  extern __shared__ float s[];  // kTileH + k - 1 rows of kColsH
  const int rows = kTileH + k - 1;
  const int half = k / 2;
  const int c0 = blockIdx.x * kColsH;
  const int r0 = blockIdx.y * kTileH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = c0 + lane, row = r0 + warp * kR;
  const size_t plane = static_cast<size_t>(h) * w;
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const float* xp = x + p * plane;
    for (int e = threadIdx.x; e < rows * kColsH; e += kThreads) {
      const int j = e / kColsH, c = e - j * kColsH;
      if (c0 + c < w) s[e] = xp[static_cast<size_t>(symmetric(r0 - half + j, h)) * w + c0 + c];
    }
    __syncthreads();
    if (col < w && row < h) {
      float acc[kR];
      tap_chain(s + warp * kR * kColsH + lane, kColsH, k, taps, acc);
      float* yc = y + p * plane + col;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (row + r < h) yc[static_cast<size_t>(row + r) * w] = acc[r];
    }
    __syncthreads();
  }
}

}  // namespace

// x, tmp, y: (planes, h, w) contiguous float32 on the device; taps: k float32
// values on the host (k odd, 1 <= k <= kMaxTaps).  Two launches on
// ``stream``: W pass x -> tmp, H pass tmp -> y.
extern "C" int ssrlcv_blur_separable(const void* x, void* tmp, void* y, int planes, int h, int w,
                                     const void* taps, int k, void* stream) {
  if (k < 1 || k > kMaxTaps || k % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (planes == 0 || h == 0 || w == 0) return 0;
  Taps t;
  for (int i = 0; i < k; ++i) t.v[i] = static_cast<double>(static_cast<const float*>(taps)[i]);
  for (int i = k; i < kMaxTaps; ++i) t.v[i] = 0.0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gz = planes < kMaxPlanesZ ? planes : kMaxPlanesZ;
  const dim3 gw((w + kTileW - 1) / kTileW, (h + kRowsW - 1) / kRowsW, gz);
  const size_t sw = static_cast<size_t>(kRowsW) * (kTileW + k - 1) * sizeof(float);
  blur_w_kernel<<<gw, kThreads, sw, st>>>(static_cast<const float*>(x), static_cast<float*>(tmp),
                                          planes, h, w, k, t);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gh((w + kColsH - 1) / kColsH, (h + kTileH - 1) / kTileH, gz);
  const size_t sh = static_cast<size_t>(kTileH + k - 1) * kColsH * sizeof(float);
  blur_h_kernel<<<gh, kThreads, sh, st>>>(static_cast<const float*>(tmp), static_cast<float*>(y),
                                          planes, h, w, k, t);
  return static_cast<int>(cudaGetLastError());
}
