// N-view track assembly on the host: the adjacency-chain builder of
// ssrlcv_tpu_torch/matching/tracks.py::build_tracks, line for line, over
// flat arrays.
//
// Replaces no TPU kernel: the JAX package builds its tracks in host Python
// (ssrlcv_tpu/matching/tracks.py::build_tracks), as the reference does.  This
// file launches nothing and reads no device memory; it is compiled into the
// kernel library only so that the port has one native library.  The Python
// builder stays the CPU path and the oracle the card tests hold this to.
//
// A hop is the code image * stride + feature, as in the Python builder, and
// the adjacency of (image i, feature f) lives at key i * stride + f of a CSR
// layout, so the key of a hop is its code.  The pairs come in sorted (i, j)
// order and each pair's matches in their order, so every adjacency list is
// in pair order, that is sorted by j.  Clearing a list sets its length to 0,
// which is what the Python builder's empty list reads as.
//
// Output: one row (track, slot, image, feature) a slot, int64, tracks in the
// order they are accepted and each track's root first.  A track is its root
// plus one slot an adjacency entry, and a key is a root at most once, so a
// graph of M matches gives at most 2 M slots.

#include <stdint.h>

#include <vector>

namespace {

// every entry of next[0, n_next) is one of prev[0, n_prev)
bool is_subset(const int64_t* next, int32_t n_next, const int64_t* prev, int32_t n_prev) {
  for (int32_t a = 0; a < n_next; ++a) {
    bool found = false;
    for (int32_t b = 0; b < n_prev && !found; ++b) found = prev[b] == next[a];
    if (!found) return false;
  }
  return true;
}

}  // namespace

// pair_ij: (num_pairs, 2) image pairs, i < j, in ascending (i, j) order;
// pair_start: (num_pairs + 1) offsets of each pair's rows in matches;
// matches: (pair_start[num_pairs], 2) rows (query feature, target feature),
// each feature in [0, stride); slots: room for max_slots rows of 4;
// counts: out (tracks, slots).  Returns 0, or -1 on an input outside these
// terms (nothing is then written to counts), -2 if max_slots is too small.
extern "C" int ssrlcv_build_tracks(const int64_t* pair_ij, const int64_t* pair_start,
                                   const int64_t* matches, int num_pairs, int num_images,
                                   int64_t stride, int64_t max_slots, int64_t* slots,
                                   int64_t* counts) {
  if (num_images < 2 || stride < 1 || num_pairs < 0) return -1;
  const int64_t n_keys = static_cast<int64_t>(num_images - 1) * stride;
  std::vector<int64_t> start(n_keys + 1, 0);
  std::vector<int32_t> len(n_keys, 0);
  for (int p = 0; p < num_pairs; ++p) {
    const int64_t i = pair_ij[2 * p], j = pair_ij[2 * p + 1];
    if (i < 0 || j <= i || j >= num_images) return -1;
    if (p > 0 && (i < pair_ij[2 * p - 2] || (i == pair_ij[2 * p - 2] && j <= pair_ij[2 * p - 1])))
      return -1;
    if (pair_start[p + 1] < pair_start[p]) return -1;
    for (int64_t m = pair_start[p]; m < pair_start[p + 1]; ++m) {
      const int64_t qf = matches[2 * m], tf = matches[2 * m + 1];
      if (qf < 0 || qf >= stride || tf < 0 || tf >= stride) return -1;
      ++start[i * stride + qf + 1];
    }
  }
  for (int64_t k = 0; k < n_keys; ++k) start[k + 1] += start[k];
  std::vector<int64_t> codes(start[n_keys]);
  for (int p = 0; p < num_pairs; ++p) {
    const int64_t i = pair_ij[2 * p], jbase = pair_ij[2 * p + 1] * stride;
    for (int64_t m = pair_start[p]; m < pair_start[p + 1]; ++m) {
      const int64_t key = i * stride + matches[2 * m];
      codes[start[key] + len[key]++] = jbase + matches[2 * m + 1];
    }
  }

  const int64_t last = num_images - 1;
  int64_t t = 0, s = 0;
  for (int64_t i = 0; i + 2 < num_images; ++i) {
    for (int64_t f = 0; f < stride; ++f) {
      const int64_t root = i * stride + f;
      const int32_t n_adj = len[root];
      if (n_adj == 0) continue;
      const int64_t* adj = codes.data() + start[root];
      bool bad = false;
      const int64_t* prev = adj;
      int32_t n_prev = n_adj;
      while (true) {
        const int64_t hop = prev[0];
        if (hop / stride == last) break;
        const int32_t n_next = len[hop];
        if (n_next == 0) break;
        const int64_t* next = codes.data() + start[hop];
        // every next-hop entry must already be in the previous adjacency
        if (!is_subset(next, n_next, prev, n_prev)) {
          bad = true;
          break;
        }
        if (n_next == 1) break;
        prev = next;
        n_prev = n_next;
      }
      if (bad) {
        len[root] = 0;
        continue;
      }
      if (s + 1 + n_adj > max_slots) return -2;
      int64_t* row = slots + 4 * s;
      row[0] = t, row[1] = 0, row[2] = i, row[3] = f;
      for (int32_t a = 0; a < n_adj; ++a) {
        row += 4;
        row[0] = t, row[1] = a + 1, row[2] = adj[a] / stride, row[3] = adj[a] % stride;
      }
      s += 1 + n_adj;
      ++t;
      // clear the consumed adjacency (all but the last hop)
      for (int32_t a = 0; a + 1 < n_adj; ++a) {
        if (adj[a] / stride == last) break;
        len[adj[a]] = 0;
      }
    }
  }
  counts[0] = t;
  counts[1] = s;
  return 0;
}
