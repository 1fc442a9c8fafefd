// K4: per query, the best target under the epipolar gate, with the
// descriptor cross term on the tensor cores; every query row is answered.
//
// Replaces the Pallas kernel ssrlcv_tpu/matching/pallas_match.py
// (_match_kernel, called from _match_call on _match_prep's inputs).  Plain
// version: ssrlcv_tpu_torch/matching/match_mma.py::best_target_mma_plain;
// best_target_mma_tiled there restates this kernel's tile schedule and
// packed-key tie rule.
//
// The TPU kernel forms ||q - t||^2 = |q|^2 + |t|^2 - 2 q.t from four
// nibble-split int8 matrix products, because its MXU takes signed int8 only.
// Hopper's integer MMA takes unsigned 8-bit operands, so here the cross term
// is one u8 x u8 -> s32 product (mma_u8, mma.sync m16n8k32), exact: every
// distance is an integer <= 128 * 255^2 = 8,323,200 < 2^23.  A target is
// admissible where it is valid with a finite x (the wrapper's mask); a
// query with no admissible target through the gate (epi_gate /
// epi_gate_pass of common.cuh, K3's) returns (0, 3.0e38), as
// _match_kernel's additive 3e38 mask gives.  Ties go to the lowest index.
//
// What bounds it on the H100: K4 answers all rows of the capacity, padding
// included, as _match_kernel does.  On the main path's seed pass that is
// 65,536 rows x ~28.4k admissible targets, ~1.9e9 pairs x 256 int8
// operations, ~0.24 ms at 1,979 TOP/s; the constrained pass needs only the
// pairs its gate admits; the inputs are ~10 MB (3 us).  Operations bound
// it, and of them the per-pair epilogue on the CUDA cores more than the
// tensor cores' products.
//
// What held the first design back: every block of 128 queries swept all 512
// target tiles of the capacity, ~57 % of them padding; tiles were loaded
// synchronously with no second buffer; the constrained pass skipped no
// tile; and each pair took ~15 instructions of epilogue (the location load,
// isfinite, the gate even for unconstrained rows, the norm load, the
// distance, compare and select).
//
// Design (8 warps a block, 16 query rows a warp, the A fragments of its 16
// rows in 16 registers; rows padded to 36 words in shared memory):
//  1. K3's tile schedule, with every row live: the wrapper runs K3's device
//     preparation (ssrlcv_match_keys, ssrlcv_match_layout in match.cu) on
//     the admissible mask, so the targets come in K3's spatial order and
//     the warps' boxes and tiles' boxes are K3's.  A tile with no
//     admissible target meets no box and is never loaded (on the main path
//     that covers the ~37k padding targets); a warp whose box misses a
//     loaded tile skips its products and epilogue.  The skip is exact by
//     K3's argument: its y-bands and x-ranges are widened against the
//     float rounding of the gate's line, so a skipped pair is one the gate
//     rejects.
//  2. The target tiles are split across blocks (blockIdx.y takes every
//     splits-th tile, so each split gets its share of the live tiles);
//     each row's (d << 32 | original index) is combined across them by an
//     integer atomicMin, and a second kernel unpacks it, "nothing
//     admitted" to (0, 3.0e38).
//  3. The next live tile is copied with cp.async while this one is used
//     (two buffers).
//  4. The epilogue is about two instructions a pair.  Within a tile the
//     wrapper orders the slots by original index (tile_sorted).  Slot j
//     carries key_j = 128 |t_j|^2 + j, or INT_MAX with a zeroed descriptor
//     when it holds no admissible target, so that its product is 0.  Per
//     accumulator entry, key_j - 256 c is one IMAD and the row's running
//     minimum one IMNMX: the value 128 (|t|^2 - 2c) + j lies in (-2^30,
//     2^30), since d < 2^23.  At the end of the tile a row whose minimum is
//     still INT_MAX had nothing there (checked before 128 |q|^2 is added,
//     which would overflow); otherwise the sum is 128 d + j, unpacked to
//     (d, j -> original index) and combined lexicographically with the
//     row's best.  A warp whose 16 rows are all unconstrained (the whole
//     seed pass) skips the gate; other warps apply epi_gate_pass first.
//     The lowest index wins ties: within a tile through j's order, across
//     tiles, threads of a quad and blocks through the (d, index) order.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQ = 16 * kWarps;  // queries per block
constexpr int kT = 128;          // targets per tile (K3's layout)
constexpr int kRowWords = 36;    // 32 descriptor words + 4 words of padding
constexpr int kMinBlocks = 3;    // blocks an SM holds: caps registers at 85 a thread
constexpr float kNoMatch = 3.0e38f;
static_assert(kT == 128, "a key is 128 |t|^2 + slot: the slot takes the low 7 bits");

struct __align__(16) Stage {
  uint32_t desc[kT * kRowWords];
  float4 meta[kT];  // K3's record: (tx, ty, |t|^2 bits or -1, original index bits)
  int key[kT];      // 128 |t|^2 + slot, INT_MAX: no admissible target
};

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
match_mma_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int* __restrict__ qn, const float4* __restrict__ tmeta,
                 const float* __restrict__ p1, const float* __restrict__ p2,
                 const long long* __restrict__ qperm, const long long* __restrict__ tperm,
                 const float4* __restrict__ qbox, const float4* __restrict__ tbox, float eps,
                 int nq, int nt, int splits, unsigned long long* __restrict__ best) {
  __shared__ Stage s[2];
  __shared__ float4 s_qbox[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group: query rows g and g + 8
  const int tq = lane & 3;  // thread in the quad
  const int slot0 = blockIdx.x * kQ + warp * 16 + g;  // query slots slot0, slot0 + 8
  const int ntiles = (nt + kT - 1) / kT;

  if (threadIdx.x < kWarps) {
    const int w = blockIdx.x * kWarps + threadIdx.x;
    const float inf = __int_as_float(0x7f800000);
    s_qbox[threadIdx.x] = w < (nq + 15) / 16 ? qbox[w] : make_float4(inf, -inf, inf, -inf);
  }
  __syncthreads();
  const float4 my_box = s_qbox[warp];

  // the first live tile of this split at or after j (ntiles or more: none);
  // the same for every thread
  auto next_live = [&](int j) {
    for (; j < ntiles; j += splits) {
      const float4 tb = tbox[j];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (overlaps(s_qbox[w], tb)) return j;
    }
    return j;
  };
  auto load = [&](int buf, int j) {
    const int t0 = j * kT;
    const int* mz = reinterpret_cast<const int*>(tmeta + t0) + 2;  // |t|^2 bits, -1: none
    for (int e = threadIdx.x; e < kT * 8; e += kWarps * 32) {
      const int r = e >> 3;
      const int tn = mz[4 * r];  // -1 also past nt: tmeta is padded to whole tiles
      const long long src = tn >= 0 ? tperm[t0 + r] : 0;
      cp_async16(&s[buf].desc[r * kRowWords + (e & 7) * 4],
                 t + static_cast<size_t>(src) * 128 + (e & 7) * 16, tn >= 0 ? 16 : 0);
      if ((e & 7) == 0) s[buf].key[r] = tn >= 0 ? tn * kT + r : INT_MAX;
    }
    for (int r = threadIdx.x; r < kT; r += kWarps * 32)
      cp_async16(&s[buf].meta[r], tmeta + t0 + r, 16);
    cp_async_commit();
  };

  uint32_t a[4][4];
  int qn128[2];
  int rows[2];
  EpiGate gate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = slot0 + 8 * r < nq;
    const int row = live ? static_cast<int>(qperm[slot0 + 8 * r]) : 0;
    rows[r] = live ? row : -1;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + static_cast<size_t>(row) * 128);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      a[ks][r] = live ? qw[ks * 8 + tq] : 0u;
      a[ks][r + 2] = live ? qw[ks * 8 + tq + 4] : 0u;
    }
    qn128[r] = live ? qn[row] * kT : 0;
    gate[r] = epi_gate(p1[2 * row], p1[2 * row + 1], p2[2 * row], p2[2 * row + 1], eps);
    if (!live) gate[r].unconstrained = true;  // a slot past nq: its result is dropped
  }
  const bool all_unconstrained =
      __all_sync(0xffffffffu, gate[0].unconstrained && gate[1].unconstrained);

  int best_d[2] = {INT_MAX, INT_MAX};
  int best_i[2] = {0, 0};
  int j = next_live(blockIdx.y);
  int buf = 0;
  if (j < ntiles) load(buf, j);
  while (j < ntiles) {
    const int jn = next_live(j + splits);
    if (jn < ntiles) {
      load(buf ^ 1, jn);  // the other buffer was released at the end of the last step
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and its keys) have landed for every thread
    if (overlaps(my_box, tbox[j])) {
      const Stage& st = s[buf];
      int m[2] = {INT_MAX, INT_MAX};  // per row: the minimum key - 256 c of the tile
      if (all_unconstrained) {
#pragma unroll 4
        for (int n0 = 0; n0 < kT; n0 += 8) {
          const uint32_t* bt = &st.desc[(n0 + g) * kRowWords + tq];
          int c[4] = {0, 0, 0, 0};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) mma_u8(c, a[ks], bt[ks * 8], bt[ks * 8 + 4]);
          // accumulator: c[0], c[1] row g, slots n0 + 2tq, +1; c[2], c[3] row g+8
          const int2 key = *reinterpret_cast<const int2*>(&st.key[n0 + 2 * tq]);
          m[0] = min(m[0], key.x - 256 * c[0]);
          m[0] = min(m[0], key.y - 256 * c[1]);
          m[1] = min(m[1], key.x - 256 * c[2]);
          m[1] = min(m[1], key.y - 256 * c[3]);
        }
      } else {
#pragma unroll 2
        for (int n0 = 0; n0 < kT; n0 += 8) {
          const uint32_t* bt = &st.desc[(n0 + g) * kRowWords + tq];
          int c[4] = {0, 0, 0, 0};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) mma_u8(c, a[ks], bt[ks * 8], bt[ks * 8 + 4]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = n0 + 2 * tq + e;
            const int key = st.key[jl];
            const float tx = st.meta[jl].x, ty = st.meta[jl].y;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (epi_gate_pass(gate[r], tx, ty)) m[r] = min(m[r], key - 256 * c[2 * r + e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (m[r] == INT_MAX) continue;  // nothing admissible for this row in this tile
        const int v = m[r] + qn128[r];  // 128 d + slot
        const int d = v >> 7;           // v >= 0
        const int ti = __float_as_int(st.meta[v & (kT - 1)].w);
        if (d < best_d[r] || (d == best_d[r] && ti < best_i[r])) {
          best_d[r] = d;
          best_i[r] = ti;
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
    if (tq == 0 && rows[r] >= 0 && bd != INT_MAX)
      atomicMin(best + rows[r], (static_cast<unsigned long long>(bd) << 32) |
                                    static_cast<unsigned int>(bi));
  }
}

// (d << 32 | idx) -> (idx, dist); all ones (nothing admitted) -> (0, 3.0e38)
__global__ void match_mma_finish(const unsigned long long* __restrict__ best, int nq,
                                 int* __restrict__ out_idx, float* __restrict__ out_dist) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nq) return;
  const unsigned long long v = best[row];
  const bool none = v == ~0ull;
  out_idx[row] = none ? 0 : static_cast<int>(v & 0xffffffffu);
  out_dist[row] = none ? kNoMatch : static_cast<float>(v >> 32);
}

}  // namespace

// K4 on K3's layout (ssrlcv_match_layout in the orders qperm / tperm, every
// row live, each tile's slots by original index): qn (nq,) int32, meta
// (ntiles * 128,) float4, qbox (ceil(nq / 16),) float4, tbox (ntiles,)
// float4; scratch: nq 8-byte words for the running (d, idx) of every row.
extern "C" int ssrlcv_match_mma(const void* q, const void* t, const void* qn, const void* meta,
                                const void* p1, const void* p2, const void* qperm,
                                const void* tperm, const void* qbox, const void* tbox, float eps,
                                int nq, int nt, void* scratch, void* out_idx, void* out_dist,
                                void* stream) {
  if (nq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* best = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * nq, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // split the target tiles so that the grid holds about 16 blocks an SM
  const int ntiles = max((nt + kT - 1) / kT, 1);
  const int qblocks = (nq + kQ - 1) / kQ;
  const int splits = min(ntiles, max(1, (16 * sms + qblocks - 1) / qblocks));
  match_mma_kernel<<<dim3(qblocks, splits), kWarps * 32, 0, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int*>(qn), static_cast<const float4*>(meta),
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const long long*>(qperm), static_cast<const long long*>(tperm),
      static_cast<const float4*>(qbox), static_cast<const float4*>(tbox), eps, nq, nt, splits,
      best);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  match_mma_finish<<<(nq + 255) / 256, 256, 0, st>>>(best, nq, static_cast<int*>(out_idx),
                                                      static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}
