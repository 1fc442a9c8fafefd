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
// What bounds it on the H100: device-memory bytes, each plane element under
// some key's patch read once plus the (K, 128) output, against one add per
// float.
// Reading every keypoint's (SPA, 128) patch straight from L2 (the first
// design: one thread per (keypoint, lane)) moves 8x those bytes, because
// patches of neighbouring keypoints overlap.
//
// Design: a memset and two launches.
//  1. link_keys (one thread a key): every key goes to a slot, one per
//     distinct (plane, x0, y0) -- x0 and y0 are clipped multiples of 128 and
//     8, so slot = (bi * NX + ceil(x0 / 128)) * NY + ceil(y0 / 8) is
//     one-to-one -- and is pushed on the slot's list with one atomicExch
//     (head[slot], next[key]; -1 ends a list).  The order inside a list
//     varies from run to run; every key of a slot gets the same sums, so the
//     output does not.
//  2. patch_row_sums_kernel: one block per band of kSlots consecutive y
//     slots of one (plane, x0) column; empty bands return at once.  The block
//     stages the rows its non-empty slots cover (at most 8 * (kSlots - 1) +
//     SPA rows of 512 bytes) into shared memory with 16-byte cp.async, so
//     each plane row segment comes in about once per band instead of once
//     per keypoint; then warp w sums slot w's SPA rows, four lanes a thread,
//     in row order, once for all the keys of that slot, and walks the slot's
//     list writing the sums to each of them.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kLW = 256;
constexpr int kSlots = 8;             // y slots (and warps) per band block

struct Geometry {
  int h, w, s, spa, nx, ny, nbands;
};

__device__ __forceinline__ int ceil8(int v) { return (v + 7) >> 3; }

__device__ __forceinline__ int key_slot(const Geometry& g, int b, int cy, int cx) {
  const int y0 = clampi((cy - g.s / 2) & ~7, 0, g.h - g.spa);
  const int x0 = clampi((cx - kLanes / 2) & ~127, 0, g.w - kLW);
  return (b * g.nx + (x0 + 127) / 128) * g.ny + ceil8(y0);
}

__global__ void link_keys(const int* __restrict__ bi, const int* __restrict__ cy,
                          const int* __restrict__ cx, int k, Geometry g, int* __restrict__ head,
                          int* __restrict__ next) {
  const int key = blockIdx.x * blockDim.x + threadIdx.x;
  if (key >= k) return;
  next[key] = atomicExch(&head[key_slot(g, bi[key], cy[key], cx[key])], key);
}

__global__ void __launch_bounds__(kSlots * 32)
patch_row_sums_kernel(const float* __restrict__ plane, Geometry g,
                      const int* __restrict__ head, const int* __restrict__ next,
                      float* __restrict__ out) {
  extern __shared__ float4 rows[];  // [row][32] float4: 128 lanes a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int band = blockIdx.x % g.nbands, column = blockIdx.x / g.nbands;  // column = b * NX + xi
  const int ys0 = band * kSlots;
  const int nslot = min(kSlots, g.ny - ys0);
  const int f0 = column * g.ny + ys0;
  // every warp reads the band's list heads: lane i holds head[f0 + i]
  const int hd = lane < nslot ? head[f0 + lane] : -1;
  const unsigned live = __ballot_sync(0xffffffffu, hd >= 0);
  if (live == 0) return;
  const int first = __ffs(live) - 1, last = 31 - __clz(live);
  const int y_first = min((ys0 + first) * 8, g.h - g.spa);
  const int y_last = min((ys0 + last) * 8, g.h - g.spa);
  const int nrows = y_last + g.spa - y_first;
  const int b = column / g.nx;
  const int x0 = min((column % g.nx) * 128, g.w - kLW);
  const float* src = plane + (static_cast<size_t>(b) * g.h + y_first) * g.w + x0;
  for (int c = threadIdx.x; c < nrows * 32; c += kSlots * 32)
    cp_async16(&rows[c], src + static_cast<size_t>(c >> 5) * g.w + (c & 31) * 4, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (!((live >> warp) & 1u)) return;
  int key = __shfl_sync(0xffffffffu, hd, warp);
  const int base = min((ys0 + warp) * 8, g.h - g.spa) - y_first;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < g.spa; ++r) {
    const float4 v = rows[(base + r) * 32 + lane];
    acc.x = __fadd_rn(acc.x, fabsf(v.x));
    acc.y = __fadd_rn(acc.y, fabsf(v.y));
    acc.z = __fadd_rn(acc.z, fabsf(v.z));
    acc.w = __fadd_rn(acc.w, fabsf(v.w));
  }
  float4* out4 = reinterpret_cast<float4*>(out);
  for (; key >= 0; key = next[key]) out4[static_cast<size_t>(key) * 32 + lane] = acc;
}

}  // namespace

// plane (b, h, w) f32, 16-byte aligned, w % 4 == 0; bi/cy/cx (k,) i32
// with bi in [0, b); scratch: slots + k int32 (slots = b * nx * ny, see
// gather_patches.slot_geometry); out (k, 128) f32.
extern "C" int ssrlcv_patch_row_sums(const void* plane, int b, int h, int w, const void* bi,
                                     const void* cy, const void* cx, int k, int s, void* scratch,
                                     void* out, void* stream) {
  if (k == 0) return 0;
  Geometry g;
  g.h = h;
  g.w = w;
  g.s = s;
  g.spa = ((s + 7) / 8) * 8 + 8;
  g.nx = (w - kLW + 127) / 128 + 1;
  g.ny = (h - g.spa + 7) / 8 + 1;
  g.nbands = (g.ny + kSlots - 1) / kSlots;
  const long long nslots = static_cast<long long>(b) * g.nx * g.ny;
  if (nslots + k > INT_MAX || w % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int* head = static_cast<int*>(scratch);
  int* next = head + nslots;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(head, 0xff, static_cast<size_t>(nslots) * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  link_keys<<<(k + 255) / 256, 256, 0, st>>>(static_cast<const int*>(bi),
                                             static_cast<const int*>(cy),
                                             static_cast<const int*>(cx), k, g, head, next);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int smem = (8 * (kSlots - 1) + g.spa) * kLanes * static_cast<int>(sizeof(float));
  e = cudaFuncSetAttribute(patch_row_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = b * g.nx * g.nbands;
  patch_row_sums_kernel<<<blocks, kSlots * 32, smem, st>>>(
      static_cast<const float*>(plane), g, head, next, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
