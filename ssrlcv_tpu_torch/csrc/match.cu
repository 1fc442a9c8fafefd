// K3: per query, the best valid target under the epipolar gate, and its
// exact squared-L2 descriptor distance.
//
// Replaces the Pallas kernel ssrlcv_tpu/matching/pallas_match.py
// (_match_kernel_i8, called from _match_call_i8 / pallas_best_target).
// Plain version: ssrlcv_tpu_torch/matching/match_kernel.py::best_target_plain
// (distance.best_target_chunked with the gate of
// match._epipolar_segment_mask).
//
// Distance: with q' = q - 128 and t' = t - 128 as int8 (u8 ^ 0x80 is that
// value), ||q - t||^2 = |q'|^2 + |t'|^2 - 2 q'.t', all int32 and exact; the
// dot is 32 __dp4a per pair.
// Gate: epi_gate / epi_gate_pass of common.cuh (shared with K4); p1.x not
// finite -> unconstrained, every valid target passes.
// Invalid targets never win; ties go to the lowest index; a query with no
// passing target returns (0, +inf).
//
// What bounds it on the H100: at 65536 x 65536 capacity the unconstrained
// pass is 4.3G pairs x 32 dp4a, about 140 G integer dot instructions,
// plus one shared-memory broadcast read per 16 descriptor bytes -- ALU
// and shared-memory-issue bound, never device-memory bound (the 8 MB of
// targets are re-read from L2 once per query block).  The constrained pass
// evaluates the gate first and skips the dot for pairs that fail it.
//
// Design: one thread per query, 128 queries per block; the query's 128
// bytes live in 32 registers.  Targets stream through shared memory in
// tiles of 128 in increasing index order; each thread keeps a running
// (best_d, best_i) in registers, replaced only on a strict '<', so ties
// keep the lowest index.  Target norms are computed once per tile.  The
// TPU kernel's (qtile, ttile) y-band skipping, tensor-core products (an
// int8 wgmma) and TMA are later performance work.
//
// Parity with the plain version:
//  * distances are exact integers on both sides;
//  * every gate term is a single rounded operation, as in the plain
//    version (common.cuh).
#include "common.cuh"

namespace {

constexpr int kQ = 128;  // queries (threads) per block
constexpr int kT = 128;  // targets per shared-memory tile

__global__ void match_best_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                                  const float* __restrict__ t_loc,
                                  const uint8_t* __restrict__ t_valid,
                                  const float* __restrict__ p1, const float* __restrict__ p2,
                                  float eps, int nq, int nt, int* __restrict__ out_idx,
                                  float* __restrict__ out_dist) {
  __shared__ uint4 s_t[kT * 8];  // kT targets x 128 bytes, centred
  __shared__ int s_tn[kT];
  __shared__ float s_tx[kT];
  __shared__ float s_ty[kT];
  __shared__ int s_tv[kT];

  const int qi = blockIdx.x * kQ + threadIdx.x;
  const bool qlive = qi < nq;

  int qw[32];
  int qn = 0;
  {
    const uint4* qv = reinterpret_cast<const uint4*>(q + static_cast<size_t>(qlive ? qi : 0) * 128);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint4 v = qv[i];
      qw[4 * i + 0] = static_cast<int>(v.x ^ 0x80808080u);
      qw[4 * i + 1] = static_cast<int>(v.y ^ 0x80808080u);
      qw[4 * i + 2] = static_cast<int>(v.z ^ 0x80808080u);
      qw[4 * i + 3] = static_cast<int>(v.w ^ 0x80808080u);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) qn = __dp4a(qw[i], qw[i], qn);
  }

  const int qr = qlive ? qi : 0;
  const EpiGate gate = epi_gate(p1[2 * qr], p1[2 * qr + 1], p2[2 * qr], p2[2 * qr + 1], eps);

  int best_d = INT_MAX;
  int best_i = 0;
  for (int t0 = 0; t0 < nt; t0 += kT) {
    const int nj = min(kT, nt - t0);
    __syncthreads();  // previous tile fully consumed
    const uint4* tv4 = reinterpret_cast<const uint4*>(t + static_cast<size_t>(t0) * 128);
    for (int e = threadIdx.x; e < kT * 8; e += blockDim.x) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (e / 8 < nj) v = tv4[e];
      v.x ^= 0x80808080u; v.y ^= 0x80808080u; v.z ^= 0x80808080u; v.w ^= 0x80808080u;
      s_t[e] = v;
    }
    if (threadIdx.x < kT) {
      const int j = threadIdx.x;
      const bool in = j < nj;
      s_tx[j] = in ? t_loc[2 * (t0 + j)] : 0.0f;
      s_ty[j] = in ? t_loc[2 * (t0 + j) + 1] : 0.0f;
      s_tv[j] = in ? static_cast<int>(t_valid[t0 + j] != 0) : 0;
    }
    __syncthreads();
    if (threadIdx.x < kT) {
      int n2 = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4 v = s_t[threadIdx.x * 8 + i];
        n2 = __dp4a(static_cast<int>(v.x), static_cast<int>(v.x), n2);
        n2 = __dp4a(static_cast<int>(v.y), static_cast<int>(v.y), n2);
        n2 = __dp4a(static_cast<int>(v.z), static_cast<int>(v.z), n2);
        n2 = __dp4a(static_cast<int>(v.w), static_cast<int>(v.w), n2);
      }
      s_tn[threadIdx.x] = n2;
    }
    __syncthreads();

    for (int j = 0; j < nj; ++j) {
      if (!s_tv[j]) continue;  // same j for every thread: no divergence
      if (!epi_gate_pass(gate, s_tx[j], s_ty[j])) continue;
      int dot = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4 v = s_t[j * 8 + i];
        dot = __dp4a(qw[4 * i + 0], static_cast<int>(v.x), dot);
        dot = __dp4a(qw[4 * i + 1], static_cast<int>(v.y), dot);
        dot = __dp4a(qw[4 * i + 2], static_cast<int>(v.z), dot);
        dot = __dp4a(qw[4 * i + 3], static_cast<int>(v.w), dot);
      }
      const int d = qn + s_tn[j] - 2 * dot;
      if (d < best_d) {
        best_d = d;
        best_i = t0 + j;
      }
    }
  }
  if (qlive) {
    out_idx[qi] = best_i;
    out_dist[qi] = best_d == INT_MAX ? __int_as_float(0x7f800000) : static_cast<float>(best_d);
  }
}

}  // namespace

extern "C" int ssrlcv_match_best(const void* q, const void* t, const void* t_loc,
                                 const void* t_valid, const void* p1, const void* p2, float eps,
                                 int nq, int nt, void* out_idx, void* out_dist, void* stream) {
  if (nq == 0) return 0;
  const int blocks = (nq + kQ - 1) / kQ;
  match_best_kernel<<<blocks, kQ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const float*>(t_loc), static_cast<const uint8_t*>(t_valid),
      static_cast<const float*>(p1), static_cast<const float*>(p2), eps, nq, nt,
      static_cast<int*>(out_idx), static_cast<float*>(out_dist));
  return static_cast<int>(cudaGetLastError());
}
