// K4: per query, the best target under the epipolar gate, with the
// descriptor cross term on the tensor cores.
//
// Replaces the Pallas kernel ssrlcv_tpu/matching/pallas_match.py
// (_match_kernel, called from _match_call on _match_prep's inputs).  Plain
// version: ssrlcv_tpu_torch/matching/match_mma.py::best_target_mma_plain.
//
// The TPU kernel forms ||q - t||^2 = |q|^2 + |t|^2 - 2 q.t from four
// nibble-split int8 matrix products, because its MXU takes signed int8 only.
// Hopper's integer MMA takes unsigned 8-bit operands, so here the cross term
// is one u8 x u8 -> s32 product (mma.sync m16n8k32), exact: every distance
// is an integer <= 128 * 255^2 < 2^24 and converts to float exactly.  The
// squared norms come from the wrapper (int32).
// Gate: epi_gate / epi_gate_pass of common.cuh, the device function K3 uses,
// plus K4's own target gate: a target counts only where its location is
// finite (the wrapper sets it to +inf where t_valid is false) and its index
// is below nt (the tail of the last tile).  Ties go to the lowest index.  A
// query with no admissible target returns (0, 3.0e38), as _match_kernel's
// additive 3e38 mask gives.
//
// What bounds it on the H100: at 65536 x 65536 capacity the products are
// 4.3G pairs x 128 MACs (1.1 int8 TOP), a millisecond of the tensor cores'
// 1,979 TOP/s peak; the per-pair epilogue (norms, gate, running minimum,
// about 15 instructions on the CUDA cores) is the larger cost, then the
// shared-memory reads of the B fragments.  Targets (8 MB) are re-read from
// L2 once per query block.
//
// Design: 8 warps per block, 16 queries per warp (one m16 tile), 128
// queries per block.  The A fragments of a warp's 16 queries (16 x 128
// bytes) stay in 16 registers for the whole sweep.  Targets stream through
// shared memory in tiles of 128 in increasing index order (plain loads, no
// TMA or wgmma yet); rows are padded to 36 words so the B-fragment reads
// (8 targets x 4 words per instruction) hit 32 distinct banks.  Per n8 tile
// of targets a warp runs 4 k-steps of mma, then each thread applies the
// gate to its 4 accumulator entries (2 queries x 2 targets) and keeps a
// running (d, idx) per query, replaced on a strict '<' in increasing target
// order.  The four threads of a quad share a query row and reduce with a
// lexicographic (d, idx) minimum, so the lowest index wins ties whatever the
// order of the reduction.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQ = 16 * kWarps;  // queries per block
constexpr int kT = 128;          // targets per shared-memory tile
constexpr int kRowWords = 36;    // 32 descriptor words + 4 words of padding
constexpr float kNoMatch = 3.0e38f;

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kWarps * 32)
match_mma_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int* __restrict__ qn, const int* __restrict__ tn,
                 const float* __restrict__ t_loc, const float* __restrict__ p1,
                 const float* __restrict__ p2, float eps, int nq, int nt,
                 int* __restrict__ out_idx, float* __restrict__ out_dist) {
  __shared__ __align__(16) uint32_t s_t[kT * kRowWords];
  __shared__ int s_tn[kT];
  __shared__ float s_tx[kT];
  __shared__ float s_ty[kT];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group: query rows g and g + 8
  const int tq = lane & 3;   // thread in the quad
  const int row0 = blockIdx.x * kQ + (threadIdx.x >> 5) * 16 + g;

  // A fragments (row-major 16 x 32 bytes per k-step): register 0 holds row g,
  // bytes 4tq..4tq+3 of the k-step; 1 row g+8; 2 row g, bytes 16+4tq..; 3 row
  // g+8, bytes 16+4tq..
  uint32_t a[4][4];
  int qn_r[2];
  EpiGate gate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool live = row < nq;
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
  for (int t0 = 0; t0 < nt; t0 += kT) {
    const int nj = min(kT, nt - t0);
    __syncthreads();  // previous tile fully consumed
    const uint4* tv4 = reinterpret_cast<const uint4*>(t + static_cast<size_t>(t0) * 128);
    for (int e = threadIdx.x; e < kT * 8; e += blockDim.x) {
      const int j = e >> 3;
      const uint4 v = j < nj ? tv4[e] : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&s_t[j * kRowWords + (e & 7) * 4]) = v;
    }
    for (int j = threadIdx.x; j < kT; j += blockDim.x) {
      const bool in = j < nj;
      s_tn[j] = in ? tn[t0 + j] : 0;
      s_tx[j] = in ? t_loc[2 * (t0 + j)] : __int_as_float(0x7f800000);
      s_ty[j] = in ? t_loc[2 * (t0 + j) + 1] : 0.0f;
    }
    __syncthreads();

    for (int n0 = 0; n0 < nj; n0 += 8) {  // nj is the same for the whole block
      // B fragment (col-major 32 x 8 bytes per k-step): target n0 + g,
      // register 0 bytes 4tq..4tq+3 of the k-step, register 1 bytes 16+4tq..
      const uint32_t* bt = &s_t[(n0 + g) * kRowWords + tq];
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) mma_u8(c, a[ks], bt[ks * 8], bt[ks * 8 + 4]);
      // accumulator: c[0], c[1] row g, targets n0 + 2tq, +1; c[2], c[3] row g+8
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int jl = n0 + 2 * tq + (i & 1);
        const float tx = s_tx[jl];
        if (!isfinite(tx) || !epi_gate_pass(gate[r], tx, s_ty[jl])) continue;
        const int d = qn_r[r] + s_tn[jl] - 2 * c[i];
        if (d < best_d[r]) {
          best_d[r] = d;
          best_i[r] = t0 + jl;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int bd = best_d[r], bi = best_i[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int row = row0 + 8 * r;
    if (tq == 0 && row < nq) {
      out_idx[row] = bd == INT_MAX ? 0 : bi;
      out_dist[row] = bd == INT_MAX ? kNoMatch : static_cast<float>(bd);
    }
  }
}

}  // namespace

extern "C" int ssrlcv_match_mma(const void* q, const void* t, const void* qn, const void* tn,
                                const void* t_loc, const void* p1, const void* p2, float eps,
                                int nq, int nt, void* out_idx, void* out_dist, void* stream) {
  if (nq == 0) return 0;
  const int blocks = (nq + kQ - 1) / kQ;
  match_mma_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int*>(qn), static_cast<const int*>(tn),
      static_cast<const float*>(t_loc), static_cast<const float*>(p1),
      static_cast<const float*>(p2), eps, nq, nt, static_cast<int*>(out_idx),
      static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}
