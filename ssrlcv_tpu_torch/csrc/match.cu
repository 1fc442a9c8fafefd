// K3: per query, the best valid target under the epipolar gate, and its
// exact squared-L2 descriptor distance.
//
// Replaces the Pallas kernel ssrlcv_tpu/matching/pallas_match.py
// (_match_kernel_i8, called from _match_call_i8 / pallas_best_target, with
// its (query-tile, target-tile) y-band skip).  Plain version:
// ssrlcv_tpu_torch/matching/match_kernel.py::best_target_plain
// (distance.best_target_chunked with the gate of match._epipolar_segment_mask);
// best_target_tiled there restates this kernel's tile-skip decisions.
//
// Distance: ||q - t||^2 = |q|^2 + |t|^2 - 2 q.t on the raw bytes, all int32
// and exact (<= 128 * 255^2 < 2^24, so the float result is exact too); the
// squared norms come from the wrapper.  Gate: epi_gate / epi_gate_pass of
// common.cuh (shared with K4); p1.x not finite -> unconstrained.  A target
// counts where t_valid holds (the wrapper stores its norm as -1 otherwise and
// for the tail of the last tile).  Ties go to the lowest index; a query with
// no passing target, or with q_valid false, returns (0, +inf).
//
// What bounds it on the H100: the main path's seed pass has ~28.5k x 28.4k
// live pairs (8.1e8): the product is 2.1e11 int8 operations, about 0.1 ms
// at 1,979 TOP/s; the inputs are ~7 MB (2 us at 3.35 TB/s).  The per-pair
// epilogue (gate, norms, running minimum: ~8 instructions on the CUDA
// cores) is the real cost for the seed pass.  The constrained pass needs
// distances only for the ~7.7e6 pairs its gate admits: its bound is the
// bytes, a few microseconds.
//
// What held the first design back: one thread per query ran 32 __dp4a and
// 8 shared loads per pair on the CUDA cores; it answered every row of the
// 65,536-row capacity, ~37k of them padding; and it had no tile skip, so
// the constrained pass evaluated the gate on every pair (8.1e8, of which
// the gate admits 7.7e6).
//
// Design:
//  * 8 warps per block, 16 queries per warp (one m16 tile); a warp's A
//    fragments (16 x 128 bytes) stay in 16 registers; the cross term of a
//    (16 query, 8 target) tile is 4 mma.sync m16n8k32 u8 (mma_u8).
//  * Targets come in tiles of 128, double-buffered through shared memory
//    with cp.async: the next live tile is in flight while this one is used.
//    Rows are padded to 36 words, so B-fragment reads hit 32 banks.
//  * Tile order: the wrapper orders the targets in strips by y, then by x,
//    so that a tile of 128 covers a compact region, and the queries the same
//    way by the midpoint of their segment (spatial_order); the kernel reads
//    both through those permutations.  Along the main path's epipolar
//    segments (steep ones, whose y-band spans most of the image) a y-sorted
//    order leaves every tile live; the region order does not.
//  * Tile skip: the wrapper gives each warp's box -- the y-band [lo, hi] of
//    _match_prep_i8 and the gate's x-range [left.x - eps, right.x + eps],
//    united over its 16 rows (unconstrained rows: everything; rows with
//    q_valid false or past nq: the neutral empty box) -- and each target
//    tile's y- and x-range over valid targets (none: empty), computed on the
//    device.  A tile no warp of the block meets is never loaded; a warp that
//    does not meet a loaded tile skips its products and epilogue.  A block
//    whose warps are all empty (capacity padding) loads nothing.
//  * The target tiles are split between blocks (blockIdx.y), about 16
//    blocks an SM in all, so that the ~220 query blocks that carry live
//    rows keep the card busy.
//  * Epilogue: per accumulator entry the target's validity, the gate, then
//    the running lexicographic (d, original index) minimum per row; the
//    quad's (quad_argmin), then an integer atomicMin of (d << 32 | index)
//    per row across the splits: the lowest index wins ties and the result
//    is the same in any order of the targets or the blocks (no float
//    atomics).  A second kernel unpacks it.
//
// Exactness of the skip: the y-bands are _match_prep_i8's (the gate admits
// a target at most eps * (1 + |slope|) outside the segment's y-range), the
// x-ranges the gate's own; both are widened by the wrapper by 1e-4 *
// max(|lo|, |hi|) + 1e-2 px against float rounding of the gate's line
// evaluation, so a skipped pair is one the gate rejects.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQ = 16 * kWarps;  // queries per block
constexpr int kT = 128;          // targets per tile (the skip's target granularity)
constexpr int kRowWords = 36;    // 32 descriptor words + 4 words of padding
constexpr int kMinBlocks = 3;    // blocks an SM holds: caps registers at 85 a thread

struct __align__(16) Stage {
  uint32_t desc[kT * kRowWords];
  float4 meta[kT];  // (tx, ty, |t|^2 as int bits or -1: not a target, index bits)
};

constexpr float kInf = __builtin_huge_valf();
constexpr double kKeyRow = 1e7;  // strip stride of the sort keys

// ---- preparation (the wrapper's plain restatement: match_kernel.py
// spatial_order, target_meta, tile_boxes; the same arithmetic, rounded
// operation by operation, so both give the same orders and boxes) ----

// min / max over a block of kPrepThreads threads; every thread gets the result
constexpr int kPrepThreads = 128;

template <bool kMax>
__device__ float block_reduce(float v, float* s_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : fminf(v, o);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s_red[0];
  for (int w = 1; w < kPrepThreads / 32; ++w) v = kMax ? fmaxf(v, s_red[w]) : fminf(v, s_red[w]);
  return v;
}

// the strip height of the sort keys from the valid targets' extent:
// sqrt(128 (x1 - x0 + 1)(y1 - y0 + 1) / max(n, 1)), at least 1; ext = (x0,
// y0, strip).  One block of kPrepThreads threads.
__global__ void match_extent(const float* __restrict__ t_loc, const uint8_t* __restrict__ t_valid,
                             int nt, double* __restrict__ ext) {
  __shared__ float s_red[kPrepThreads / 32];
  float x0 = kInf, y0 = kInf, x1 = -kInf, y1 = -kInf, n = 0.0f;
  for (int i = threadIdx.x; i < nt; i += kPrepThreads) {
    if (!t_valid[i]) continue;
    const float x = t_loc[2 * i], y = t_loc[2 * i + 1];
    x0 = fminf(x0, x);
    x1 = fmaxf(x1, x);
    y0 = fminf(y0, y);
    y1 = fmaxf(y1, y);
    n += 1.0f;  // exact: counts stay below 2^24
  }
  x0 = block_reduce<false>(x0, s_red);
  y0 = block_reduce<false>(y0, s_red);
  x1 = block_reduce<true>(x1, s_red);
  y1 = block_reduce<true>(y1, s_red);
  // the sum of the per-thread counts, in float: exact integers
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    double cnt = 0.0;
    for (int w = 0; w < kPrepThreads / 32; ++w) cnt += s_red[w];
    const double dx = __dadd_rn(__dsub_rn(x1, x0), 1.0);
    const double dy = __dadd_rn(__dsub_rn(y1, y0), 1.0);
    const double area = __dmul_rn(__dmul_rn(128.0, dx), dy);
    double strip = fmax(__dsqrt_rn(__ddiv_rn(area, fmax(cnt, 1.0))), 1.0);
    if (isnan(strip) || isinf(strip)) strip = 1.0;
    ext[0] = x0;
    ext[1] = y0;
    ext[2] = strip;
  }
}

__device__ __forceinline__ double sort_key(double x, double y, const double* ext) {
  return __dadd_rn(__dmul_rn(floor(__ddiv_rn(__dsub_rn(y, ext[1]), ext[2])), kKeyRow),
                   __dsub_rn(x, ext[0]));
}

// sort keys: valid targets by (strip of y, x), others +inf; queries by the
// midpoint of their segment, unconstrained rows -inf, q_valid false +inf
__global__ void match_keys(const float* __restrict__ t_loc, const uint8_t* __restrict__ t_valid,
                           int nt, const float* __restrict__ p1, const float* __restrict__ p2,
                           const uint8_t* __restrict__ q_valid, int nq,
                           const double* __restrict__ ext, double* __restrict__ tkey,
                           double* __restrict__ qkey) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const double inf = __builtin_huge_val();
  if (i < nt) tkey[i] = t_valid[i] ? sort_key(t_loc[2 * i], t_loc[2 * i + 1], ext) : inf;
  if (i < nq) {
    double k = -inf;
    if (isfinite(p1[2 * i])) {
      const double mx = __ddiv_rn(__dadd_rn(p1[2 * i], p2[2 * i]), 2.0);
      const double my = __ddiv_rn(__dadd_rn(p1[2 * i + 1], p2[2 * i + 1]), 2.0);
      k = sort_key(mx, my, ext);
      if (isnan(k)) k = inf;
    }
    if (q_valid != nullptr && !q_valid[i]) k = inf;
    qkey[i] = k;
  }
}

__device__ __forceinline__ int sq_norm(const uint8_t* row) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
  unsigned int acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 w = v[i];
    acc = __dp4a(w.x, w.x, acc);
    acc = __dp4a(w.y, w.y, acc);
    acc = __dp4a(w.z, w.z, acc);
    acc = __dp4a(w.w, w.w, acc);
  }
  return static_cast<int>(acc);
}

__device__ __forceinline__ float widen_pad(float lo, float hi) {
  return __fadd_rn(__fmul_rn(1e-4f, fmaxf(fabsf(lo), fabsf(hi))), 1e-2f);
}

// blocks [0, ntiles): one target tile each -- meta per slot and the tile's
// box; blocks [ntiles, ..): 128 query slots each -- |q|^2 per row and the
// widened box per 16 slots
__global__ void __launch_bounds__(kPrepThreads)
match_layout(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
             const float* __restrict__ t_loc, const uint8_t* __restrict__ t_valid,
             const float* __restrict__ p1, const float* __restrict__ p2,
             const uint8_t* __restrict__ q_valid, const long long* __restrict__ qperm,
             const long long* __restrict__ tperm, float eps, int nq, int nt, int ntiles,
             int* __restrict__ qn, float4* __restrict__ meta, float4* __restrict__ qbox,
             float4* __restrict__ tbox) {
  __shared__ float s_red[kPrepThreads / 32];
  if (static_cast<int>(blockIdx.x) < ntiles) {
    const int slot = blockIdx.x * kPrepThreads + threadIdx.x;
    float4 m = make_float4(0.0f, 0.0f, __int_as_float(-1), __int_as_float(0));
    float ylo = kInf, yhi = -kInf, xlo = kInf, xhi = -kInf;
    if (slot < nt) {
      const int i = static_cast<int>(tperm[slot]);
      const float x = t_loc[2 * i], y = t_loc[2 * i + 1];
      const bool v = t_valid[i] != 0;
      m = make_float4(x, y, __int_as_float(v ? sq_norm(t + static_cast<size_t>(i) * 128) : -1),
                      __int_as_float(i));
      if (v) {
        ylo = yhi = y;
        xlo = xhi = x;
      }
    }
    meta[slot] = m;
    ylo = block_reduce<false>(ylo, s_red);
    yhi = block_reduce<true>(yhi, s_red);
    xlo = block_reduce<false>(xlo, s_red);
    xhi = block_reduce<true>(xhi, s_red);
    if (threadIdx.x == 0) tbox[blockIdx.x] = make_float4(ylo, yhi, xlo, xhi);
    return;
  }
  const int slot = (blockIdx.x - ntiles) * kPrepThreads + threadIdx.x;
  float ylo = kInf, yhi = -kInf, xlo = kInf, xhi = -kInf;
  if (slot < nq) {
    const int i = static_cast<int>(qperm[slot]);
    qn[i] = sq_norm(q + static_cast<size_t>(i) * 128);
    const float ax = p1[2 * i], ay = p1[2 * i + 1], bx = p2[2 * i], by = p2[2 * i + 1];
    if (q_valid == nullptr || q_valid[i]) {
      if (!isfinite(ax)) {
        ylo = xlo = -kInf;
        yhi = xhi = kInf;
      } else {
        const float dxs = fabsf(__fsub_rn(ax, bx));
        const float dys = fabsf(__fsub_rn(ay, by));
        const bool vertical = dxs == 0.0f;
        const float slope = __fdiv_rn(dys, vertical ? 1.0f : dxs);
        const float slack = vertical ? eps : __fmul_rn(eps, __fadd_rn(1.0f, slope));
        ylo = __fsub_rn(fminf(ay, by), slack);
        yhi = __fadd_rn(fmaxf(ay, by), slack);
        const bool swap = ax >= bx;
        xlo = __fsub_rn(swap ? bx : ax, eps);
        xhi = __fadd_rn(swap ? ax : bx, eps);
      }
    }
  }
  // the union over each 16 slots (half a warp)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, off));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, off));
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, off));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, off));
  }
  const int w = slot >> 4;
  if ((threadIdx.x & 15) == 0 && w < (nq + 15) / 16) {
    const bool fy = isfinite(ylo) && isfinite(yhi), fx = isfinite(xlo) && isfinite(xhi);
    const float py = widen_pad(ylo, yhi), px = widen_pad(xlo, xhi);
    qbox[w] = make_float4(fy ? __fsub_rn(ylo, py) : ylo, fy ? __fadd_rn(yhi, py) : yhi,
                          fx ? __fsub_rn(xlo, px) : xlo, fx ? __fadd_rn(xhi, px) : xhi);
  }
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
match_best_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  const int* __restrict__ qn, const float4* __restrict__ tmeta,
                  const float* __restrict__ p1, const float* __restrict__ p2,
                  const uint8_t* __restrict__ q_valid, const long long* __restrict__ qperm,
                  const long long* __restrict__ tperm, const float4* __restrict__ qbox,
                  const float4* __restrict__ tbox, float eps, int nq, int nt,
                  int tiles_per_split, unsigned long long* __restrict__ best) {
  __shared__ Stage s[2];
  __shared__ float4 s_qbox[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group: query rows g and g + 8
  const int tq = lane & 3;  // thread in the quad
  const int slot0 = blockIdx.x * kQ + warp * 16 + g;  // query slots slot0, slot0 + 8
  // this block's share of the target tiles: blockIdx.y-th split
  const int j_begin = blockIdx.y * tiles_per_split;
  const int ntiles = min((nt + kT - 1) / kT, j_begin + tiles_per_split);

  if (threadIdx.x < kWarps) {
    const int w = blockIdx.x * kWarps + threadIdx.x;
    const float inf = __int_as_float(0x7f800000);
    s_qbox[threadIdx.x] = w < (nq + 15) / 16 ? qbox[w] : make_float4(inf, -inf, inf, -inf);
  }
  __syncthreads();
  const float4 my_box = s_qbox[warp];

  // the first live tile at or after j of this split (ntiles: none); the
  // same for every thread
  auto next_live = [&](int j) {
    for (; j < ntiles; ++j) {
      const float4 tb = tbox[j];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (overlaps(s_qbox[w], tb)) return j;
    }
    return j;
  };
  auto load = [&](int buf, int j) {
    const int t0 = j * kT;
    for (int e = threadIdx.x; e < kT * 8; e += kWarps * 32) {
      const int r = e >> 3;
      const bool in = t0 + r < nt;
      const long long src = in ? tperm[t0 + r] : 0;
      cp_async16(&s[buf].desc[r * kRowWords + (e & 7) * 4],
                 t + static_cast<size_t>(src) * 128 + (e & 7) * 16, in ? 16 : 0);
    }
    for (int r = threadIdx.x; r < kT; r += kWarps * 32)
      cp_async16(&s[buf].meta[r], tmeta + t0 + r, 16);  // tmeta is padded to whole tiles
    cp_async_commit();
  };

  uint32_t a[4][4];
  int qn_r[2];
  int rows[2];
  EpiGate gate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = slot0 + 8 * r < nq;
    const int row = live ? static_cast<int>(qperm[slot0 + 8 * r]) : 0;
    rows[r] = live ? row : -1;
    const uint32_t* qw =
        reinterpret_cast<const uint32_t*>(q + static_cast<size_t>(live ? row : 0) * 128);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      a[ks][r] = live ? qw[ks * 8 + tq] : 0u;
      a[ks][r + 2] = live ? qw[ks * 8 + tq + 4] : 0u;
    }
    qn_r[r] = live ? qn[row] : 0;
    const int pr = live ? row : 0;
    gate[r] = epi_gate(p1[2 * pr], p1[2 * pr + 1], p2[2 * pr], p2[2 * pr + 1], eps);
  }

  int best_d[2] = {INT_MAX, INT_MAX};
  int best_i[2] = {0, 0};
  int j = next_live(j_begin);
  int buf = 0;
  if (j < ntiles) load(buf, j);
  while (j < ntiles) {
    const int jn = next_live(j + 1);
    if (jn < ntiles) {
      load(buf ^ 1, jn);  // the other buffer was released at the end of the last step
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread
    if (overlaps(my_box, tbox[j])) {
      const Stage& st = s[buf];
#pragma unroll 2
      for (int n0 = 0; n0 < kT; n0 += 8) {
        const uint32_t* bt = &st.desc[(n0 + g) * kRowWords + tq];
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) mma_u8(c, a[ks], bt[ks * 8], bt[ks * 8 + 4]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = n0 + 2 * tq + e;
          const float4 m = st.meta[jl];
          const int tn = __float_as_int(m.z);
          if (tn < 0) continue;
          const int ti = __float_as_int(m.w);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (!epi_gate_pass(gate[r], m.x, m.y)) continue;
            const int d = qn_r[r] + tn - 2 * c[2 * r + e];
            if (d < best_d[r] || (d == best_d[r] && ti < best_i[r])) {
              best_d[r] = d;
              best_i[r] = ti;
            }
          }
        }
      }
    }
    __syncthreads();  // tile j consumed before its buffer is refilled
    buf ^= 1;
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int bd = best_d[r], bi = best_i[r];
    quad_argmin(bd, bi);
    const int row = rows[r];
    if (tq == 0 && row >= 0 && bd != INT_MAX && (q_valid == nullptr || q_valid[row]))
      atomicMin(best + row, (static_cast<unsigned long long>(bd) << 32) |
                                static_cast<unsigned int>(bi));
  }
}

// (d << 32 | idx) -> (idx, dist); all ones (nothing passed) -> (0, +inf)
__global__ void match_best_finish(const unsigned long long* __restrict__ best, int nq,
                                  int* __restrict__ out_idx, float* __restrict__ out_dist) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nq) return;
  const unsigned long long v = best[row];
  const bool none = v == ~0ull;
  out_idx[row] = none ? 0 : static_cast<int>(v & 0xffffffffu);
  out_dist[row] = none ? __int_as_float(0x7f800000) : static_cast<float>(v >> 32);
}

}  // namespace

// Step 1 of a K3 call: the sort keys of targets and queries (ext: 4
// doubles of workspace; tkey (nt,), qkey (nq,) doubles).  The wrapper sorts
// them (stable) into tperm / qperm for step 2.
extern "C" int ssrlcv_match_keys(const void* t_loc, const void* t_valid, int nt, const void* p1,
                                 const void* p2, const void* q_valid, int nq, void* ext,
                                 void* tkey, void* qkey, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  match_extent<<<1, kPrepThreads, 0, st>>>(static_cast<const float*>(t_loc),
                                            static_cast<const uint8_t*>(t_valid), nt,
                                            static_cast<double*>(ext));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = max(max(nt, nq), 1);
  match_keys<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(t_loc), static_cast<const uint8_t*>(t_valid), nt,
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const uint8_t*>(q_valid), nq, static_cast<const double*>(ext),
      static_cast<double*>(tkey), static_cast<double*>(qkey));
  return static_cast<int>(cudaGetLastError());
}

// Step 2a: the layout in the orders qperm / tperm (qn (nq,) int32, meta
// (ntiles * 128,) float4, qbox (ceil(nq / 16),) float4, tbox (ntiles,)
// float4).  K4 (match_mma.cu) takes the same layout through its wrapper.
extern "C" int ssrlcv_match_layout(const void* q, const void* t, const void* t_loc,
                                   const void* t_valid, const void* p1, const void* p2,
                                   const void* q_valid, const void* qperm, const void* tperm,
                                   float eps, int nq, int nt, void* qn, void* meta, void* qbox,
                                   void* tbox, void* stream) {
  if (nq == 0) return 0;
  const int ntiles = max((nt + kT - 1) / kT, 1);
  match_layout<<<ntiles + (nq + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const float*>(t_loc), static_cast<const uint8_t*>(t_valid),
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const uint8_t*>(q_valid), static_cast<const long long*>(qperm),
      static_cast<const long long*>(tperm), eps, nq, nt, ntiles, static_cast<int*>(qn),
      static_cast<float4*>(meta), static_cast<float4*>(qbox), static_cast<float4*>(tbox));
  return static_cast<int>(cudaGetLastError());
}

// Step 2b: the best targets on a layout of step 2a (scratch: nq 8-byte
// words for the running (d, idx) of every row).
extern "C" int ssrlcv_match_run(const void* q, const void* t, const void* q_valid,
                                const void* p1, const void* p2, const void* qperm,
                                const void* tperm, float eps, int nq, int nt, const void* qn,
                                const void* meta, const void* qbox, const void* tbox,
                                void* scratch, void* out_idx, void* out_dist, void* stream) {
  if (nq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = max((nt + kT - 1) / kT, 1);
  auto* best = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * nq, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // split the target tiles so that the grid holds about 16 blocks an SM
  const int qblocks = (nq + kQ - 1) / kQ;
  const int splits = min(ntiles, max(1, (16 * sms + qblocks - 1) / qblocks));
  const int per = (ntiles + splits - 1) / splits;
  match_best_kernel<<<dim3(qblocks, (ntiles + per - 1) / per), kWarps * 32, 0, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int*>(qn), static_cast<const float4*>(meta),
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const uint8_t*>(q_valid), static_cast<const long long*>(qperm),
      static_cast<const long long*>(tperm), static_cast<const float4*>(qbox),
      static_cast<const float4*>(tbox), eps, nq, nt, per, best);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  match_best_finish<<<(nq + 255) / 256, 256, 0, st>>>(best, nq, static_cast<int*>(out_idx),
                                                       static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}
