"""Feature matching: seed distances and Earth-segment ("double") constrained
epipolar matching, then 2-view match-set assembly.

Counterpart of the 2-view path of ``ssrlcv_tpu/matching/match.py``.  Both
passes go through kernel K3 (``match_kernel.best_target``); thresholds and
invalidation follow the reference kernels:

  * invalid if best_dist >= absolute_threshold;
  * with seed distances, also invalid if best_dist / seed_dist >
    relative_threshold^2;
  * the double-constrained gate is the reference's literal test (x-range
    around the segment plus the vertical distance to its line).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ssrlcv_tpu.config import MatchParams
from ssrlcv_tpu_torch.core import camera_math
from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet, MatchSet
from ssrlcv_tpu_torch.matching.match_kernel import best_target


class DMatches(NamedTuple):
    """Per-query match results."""

    target_idx: torch.Tensor  # (Nq,) int32
    distance: torch.Tensor    # (Nq,) float32
    valid: torch.Tensor       # (Nq,) bool


def _unconstrained(n: int, device) -> torch.Tensor:
    return torch.full((n, 2), torch.inf, dtype=torch.float32, device=device)


def seed_distances(features: FeatureSet, seed: FeatureSet) -> torch.Tensor:
    """Nearest seed-descriptor distance per feature (the unconstrained K3
    pass)."""
    inf2 = _unconstrained(features.capacity, features.loc.device)
    _, dist = best_target(features.descriptors, seed.descriptors, seed.loc.contiguous(),
                          inf2, inf2, 0.0, seed.mask)
    return dist


def _threshold(idx, dist, q_mask, params: MatchParams, seed_dist) -> DMatches:
    valid = q_mask & torch.isfinite(dist) & (dist < params.absolute_threshold)
    if seed_dist is not None:
        rel = params.relative_threshold ** 2
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
