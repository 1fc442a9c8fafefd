"""Feature matching: brute force, F-matrix constrained, Earth-segment
("double") constrained, then 2-view match-set assembly and the match-list
utilities.

Counterpart of the 2-view path of ``ssrlcv_tpu/matching/match.py``.  The
seed pass, the double-constrained match and (for 128-wide SIFT descriptors
under squared L2 on a CUDA device) the brute-force match go through kernel
K3 (``match_kernel.best_target``); the rest uses the chunked plain matcher
(``distance.best_target_chunked``).  Thresholds and invalidation follow the
reference kernels:

  * invalid if best_dist >= absolute_threshold;
  * with seed distances, also invalid if best_dist / seed_dist >
    relative_threshold^2 (the index-only kernel family compares against
    relative_threshold, unsquared);
  * the double-constrained gate is the reference's literal test (x-range
    around the segment plus the vertical distance to its line); the
    F-matrix gate is the perpendicular distance to the epipolar line.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ssrlcv_tpu.config import MatchParams
from ssrlcv_tpu_torch.core import camera_math
from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet, MatchSet
from ssrlcv_tpu_torch.matching.distance import best_target_chunked
from ssrlcv_tpu_torch.matching.match_kernel import best_target


class DMatches(NamedTuple):
    """Per-query match results."""

    target_idx: torch.Tensor  # (Nq,) int32
    distance: torch.Tensor    # (Nq,) float32
    valid: torch.Tensor       # (Nq,) bool


def _unconstrained(n: int, device) -> torch.Tensor:
    return torch.full((n, 2), torch.inf, dtype=torch.float32, device=device)


def _use_kernel(query, metric: str, backend: str) -> bool:
    """K3 for ``backend="kernel"``; for "auto" when it applies (squared L2
    on 128-wide descriptors) and the data lies on a CUDA device;
    ``best_target_chunked`` otherwise."""
    if backend not in ("auto", "kernel", "chunked"):
        raise ValueError(f"backend must be 'auto', 'kernel' or 'chunked', got {backend!r}")
    kernel_ok = metric == "l2sq" and query.descriptors.shape[1] == 128
    return backend == "kernel" or (backend == "auto" and kernel_ok
                                   and query.descriptors.device.type == "cuda")


def seed_distances(features: FeatureSet, seed: FeatureSet, chunk: int = 1024,
                   metric: str = "l2sq") -> torch.Tensor:
    """Nearest seed-descriptor distance per feature: the unconstrained K3
    pass for squared L2 on 128-wide descriptors, the chunked plain pass
    otherwise."""
    if metric == "l2sq" and features.descriptors.shape[1] == 128:
        inf2 = _unconstrained(features.capacity, features.loc.device)
        _, dist = best_target(features.descriptors, seed.descriptors, seed.loc.contiguous(),
                              inf2, inf2, 0.0, seed.mask)
        return dist
    return best_target_chunked(features.descriptors, seed.descriptors, seed.mask, chunk=chunk,
                               metric=metric)[1]


def _threshold(idx, dist, q_mask, params: MatchParams, seed_dist,
               squared: bool = True) -> DMatches:
    valid = q_mask & torch.isfinite(dist) & (dist < params.absolute_threshold)
    if seed_dist is not None:
        rel = params.relative_threshold ** 2 if squared else params.relative_threshold
        valid = valid & (dist / torch.clamp(seed_dist, min=1e-20) <= rel)
    return DMatches(target_idx=idx, distance=dist, valid=valid)


def match_double_constrained(query: FeatureSet, target: FeatureSet, cameras: Cameras,
                             query_index: int, target_index: int, params: MatchParams,
                             seed_dist: Optional[torch.Tensor] = None) -> DMatches:
    """Earth-geometry epipolar-segment constrained matching of ``query``
    features against ``target`` features (the constrained K3 pass)."""
    qi, ti = query_index, target_index
    P = camera_math.projection_matrix(
        cameras.cam_pos[ti], cameras.cam_rot[ti], cameras.foc[ti],
        cameras.dpix[ti], cameras.size[ti], cameras.ecef_offset[ti])
    p1, p2 = camera_math.epipolar_segment_endpoints(
        query.loc, cameras.cam_pos[qi], cameras.cam_rot[qi], cameras.foc[qi],
        cameras.dpix[qi], cameras.size[qi], cameras.ecef_offset[qi], P, params.delta)
    idx, dist = best_target(query.descriptors, target.descriptors, target.loc.contiguous(),
                            p1.contiguous(), p2.contiguous(), params.epsilon, target.mask)
    return _threshold(idx, dist, query.mask, params, seed_dist)


def match_brute_force(query: FeatureSet, target: FeatureSet, params: MatchParams,
                      seed_dist: Optional[torch.Tensor] = None, chunk: int = 1024,
                      backend: str = "auto", index_only: bool = False,
                      metric: str = "l2sq") -> DMatches:
    """Unconstrained nearest-target matching.  backend: 'kernel' (K3 with
    every segment +inf and epsilon 0), 'chunked' (``best_target_chunked``)
    or 'auto' (K3 for squared L2 on 128-wide descriptors on a CUDA device,
    chunked otherwise).  index_only: the unsquared relative-seed
    threshold."""
    if _use_kernel(query, metric, backend):
        inf2 = _unconstrained(query.capacity, query.loc.device)
        idx, dist = best_target(query.descriptors, target.descriptors, target.loc.contiguous(),
                                inf2, inf2, 0.0, target.mask)
    else:
        idx, dist = best_target_chunked(query.descriptors, target.descriptors, target.mask,
                                        chunk=chunk, metric=metric)
    return _threshold(idx, dist, query.mask, params, seed_dist, squared=not index_only)


def _fmatrix_mask(q_loc, F, t_loc, epsilon: float) -> torch.Tensor:
    """Plain epipolar-line constraint: perpendicular distance of each target
    point to the query's epipolar line F @ [q, 1] <= epsilon; (C, Nt)."""
    qh = torch.cat([q_loc, torch.ones_like(q_loc[:, :1])], dim=1)
    lines = qh @ F.T
    d = (lines[:, None, 0] * t_loc[None, :, 0] + lines[:, None, 1] * t_loc[None, :, 1]
         + lines[:, None, 2])
    norm = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[:, None]
    return torch.abs(d) / torch.clamp(norm, min=1e-20) <= epsilon


def match_fmatrix_constrained(query: FeatureSet, target: FeatureSet, F: torch.Tensor,
                              params: MatchParams, seed_dist: Optional[torch.Tensor] = None,
                              chunk: int = 1024, metric: str = "l2sq") -> DMatches:
    """F-matrix epipolar-line constrained matching (chunked plain matcher)."""
    idx, dist = best_target_chunked(
        query.descriptors, target.descriptors, target.mask,
        mask_fn=lambda q: _fmatrix_mask(q, F, target.loc, params.epsilon),
        mask_aux=(query.loc,), chunk=chunk, metric=metric)
    return _threshold(idx, dist, query.mask, params, seed_dist)


class IndexPairs(NamedTuple):
    """Index-only matches: per query ((query image, query feature), (target
    image, target feature)); invalid slots keep the two halves equal, the
    reference's invalid encoding."""

    query_parent: torch.Tensor   # (Nq,) int32 image ids
    query_idx: torch.Tensor      # (Nq,) int32 feature indices
    target_parent: torch.Tensor  # (Nq,) int32
    target_idx: torch.Tensor     # (Nq,) int32
    valid: torch.Tensor          # (Nq,) bool


def match_index_only(dm: DMatches, query_id: int, target_id: int) -> IndexPairs:
    """DMatches -> the index-only pair form."""
    n = dm.target_idx.shape[0]
    dev = dm.target_idx.device
    qidx = torch.arange(n, dtype=torch.int32, device=dev)
    qpar = torch.full((n,), query_id, dtype=torch.int32, device=dev)
    tpar = torch.where(dm.valid, torch.tensor(target_id, dtype=torch.int32, device=dev), qpar)
    tidx = torch.where(dm.valid, dm.target_idx.to(torch.int32), qidx)
    return IndexPairs(qpar, qidx, tpar, tidx, dm.valid)


def validate_matches(dm: DMatches) -> DMatches:
    """Valid matches to the front in order (stable); invalid slots to the
    tail with distance +inf."""
    order = torch.argsort((~dm.valid).to(torch.uint8), stable=True)
    return DMatches(target_idx=dm.target_idx[order],
                    distance=torch.where(dm.valid[order], dm.distance[order], torch.inf),
                    valid=dm.valid[order])


def refine_matches(dm: DMatches, threshold: float) -> DMatches:
    """Drop matches with distance > threshold (a positive threshold)."""
    return DMatches(target_idx=dm.target_idx, distance=dm.distance,
                    valid=dm.valid & (dm.distance <= threshold))


def sort_matches(dm: DMatches) -> DMatches:
    """Sort by ascending distance, stable; invalid slots to the end (+inf)."""
    key = torch.where(dm.valid, dm.distance, torch.inf)
    order = torch.argsort(key, stable=True)
    return DMatches(target_idx=dm.target_idx[order], distance=key[order], valid=dm.valid[order])


def _pair_parents(n: int, query_id: int, target_id: int, device) -> torch.Tensor:
    ids = torch.tensor([query_id, target_id], dtype=torch.int32, device=device)
    return ids.expand(n, 2)


def get_raw_matches(dm: DMatches, query: FeatureSet, target: FeatureSet, query_id: int,
                    target_id: int):
    """Keypoint pairs without distances, in query order: (loc (Nq, 2, 2),
    parent (Nq, 2), valid (Nq,))."""
    tgt = torch.clamp(dm.target_idx.to(torch.int64), 0, target.capacity - 1)
    loc = torch.stack([query.loc, target.loc[tgt]], dim=1)
    return loc, _pair_parents(dm.valid.shape[0], query_id, target_id, loc.device), dm.valid


class FeatureMatches(NamedTuple):
    """Descriptor-carrying matches (struct-of-arrays)."""

    loc: torch.Tensor          # (Nq, 2, 2) float32 [query kp, target kp]
    parent: torch.Tensor       # (Nq, 2) int32 image ids
    descriptors: torch.Tensor  # (Nq, 2, D) [query desc, target desc]
    distance: torch.Tensor     # (Nq,) float32
    valid: torch.Tensor        # (Nq,) bool


def get_feature_matches(dm: DMatches, query: FeatureSet, target: FeatureSet, query_id: int,
                        target_id: int) -> FeatureMatches:
    """DMatches -> descriptor-carrying matches in query order; invalid slots
    keep their best candidate's payload."""
    tgt = torch.clamp(dm.target_idx.to(torch.int64), 0, target.capacity - 1)
    loc = torch.stack([query.loc, target.loc[tgt]], dim=1)
    desc = torch.stack([query.descriptors, target.descriptors[tgt]], dim=1)
    return FeatureMatches(loc=loc,
                          parent=_pair_parents(dm.valid.shape[0], query_id, target_id,
                                               loc.device),
                          descriptors=desc, distance=dm.distance, valid=dm.valid)


def matches_to_matchset(dm: DMatches, query: FeatureSet, target: FeatureSet,
                        query_id: int, target_id: int,
                        capacity: Optional[int] = None) -> MatchSet:
    """The 2-view MatchSet: track i = (query kp, matched target kp) over the
    valid matches in query order, capacity rounded up to 128 (at least
    128) unless given."""
    order = torch.argsort((~dm.valid).to(torch.uint8), stable=True)
    if capacity is None:
        n = int(dm.valid.sum())
        capacity = max(((n + 127) // 128) * 128, 128)
    nq = order.shape[0]
    if capacity > nq:
        order = torch.cat([order, torch.zeros(capacity - nq, dtype=order.dtype,
                                              device=order.device)])
    order = order[:capacity]
    v = dm.valid[order] & (torch.arange(capacity, device=order.device) < nq)
    tgt = torch.clamp(dm.target_idx[order].to(torch.int64), 0, target.loc.shape[0] - 1)
    kp_loc = torch.stack([query.loc[order], target.loc[tgt]], dim=1)
    kp_loc = torch.where(v[:, None, None], kp_loc, 0.0)
    ids = torch.tensor([query_id, target_id], dtype=torch.int32, device=order.device)
    kp_par = torch.where(v[:, None], ids[None, :], -1).to(torch.int32)
    return MatchSet(kp_loc=kp_loc, kp_parent=kp_par,
                    num_views=torch.where(v, 2, 0).to(torch.int32), mask=v)
