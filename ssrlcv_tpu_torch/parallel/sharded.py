"""Sharded pipeline stages over a (data, feat) mesh of ``torch.distributed``
ranks: distributed matching, image-parallel SIFT, the N-view pair sweep,
track-sharded triangulation and bundle adjustment.

Counterpart of ``ssrlcv_tpu/parallel/sharded.py``, with its names.  Every
rank holds the stage's full inputs (features, match sets, cameras), takes
its own shard of the work and meets the others in collectives
(``parallel.mesh``), so that every rank returns the same full result:

  * matching -- queries sharded over ``data``, targets over ``feat``; each
    rank runs kernel K3 (``matching.match_kernel.best_target``: the
    epipolar gate fused, no float32 distance tile) on its (query, target)
    shard, then a MIN of the distance over ``feat`` and a MIN of the global
    target index among the ranks that hold it;
  * SIFT -- images dealt in blocks over the flattened mesh, each rank running
    ``generate_features`` on its own, then gathered;
  * the N-view pair sweep -- pairs dealt round-robin over the flattened
    mesh, each rank matching its own (K3), then a padded all-gather;
  * triangulation and bundle adjustment -- tracks sharded over ``data``; BA
    sums each shard's error, gradient and Hessian over ``data`` and solves
    the damped system on every rank, deciding each LM step on the summed
    scalars alone, so every rank takes the same steps.

On CPU tensors K3 takes its plain version, through its wrapper, as
everywhere else.  PyTorch runs eagerly, so the JAX package's caches of
jitted closures have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import grad, hessian

from ssrlcv_tpu_torch.config import MatchParams
from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet, MatchSet
from ssrlcv_tpu_torch.parallel.mesh import (DATA_AXIS, FEAT_AXIS, all_gather, all_gather_ragged,
                                            all_reduce, axis_rank, axis_size, flat_rank,
                                            host_tree, host_value)

_NO_INDEX = torch.iinfo(torch.int64).max


def _pad_to(x: torch.Tensor, multiple: int, fill=0) -> torch.Tensor:
    """Pad the leading axis up to a multiple with ``fill``."""
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    pad = torch.full((target - n,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def pad_matchset(ms: MatchSet, multiple: int) -> MatchSet:
    """Pad tracks (mask False) so the track axis divides the data axis."""
    return MatchSet(kp_loc=_pad_to(ms.kp_loc, multiple),
                    kp_parent=_pad_to(ms.kp_parent, multiple, fill=-1),
                    num_views=_pad_to(ms.num_views, multiple),
                    mask=_pad_to(ms.mask, multiple))


def _shard(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's block of the leading axis (which the axis size divides)."""
    n = x.shape[0] // axis_size(mesh, axis)
    r = axis_rank(mesh, axis)
    return x[r * n:(r + 1) * n]


def sharded_best_target(mesh, q_desc, t_desc, t_valid, p1=None, p2=None, t_loc=None,
                        epsilon: float = 0.0, q_valid=None):
    """Distributed best target: (idx int32, dist float32) per query, the
    full (Nq,) result on every rank.

    q_desc (Nq, 128) u8 is sharded over data, t_desc (Nt, 128) u8 and
    t_valid (Nt,) over feat; Nq must divide by the data size and Nt by the
    feat size (pad first).  With (p1, p2, t_loc) the double-constrained
    epipolar-segment gate is fused into K3, as in the single-device
    matchers.  Rows that no shard admits a target for, or with ``q_valid``
    false, get (0, +inf), as from the single-device K3.  Ties (exact
    integer distances) go to the lowest global index."""
    from ssrlcv_tpu_torch.matching.match_kernel import best_target

    dsz, fsz = axis_size(mesh, DATA_AXIS), axis_size(mesh, FEAT_AXIS)
    nq, nt = q_desc.shape[0], t_desc.shape[0]
    if nq % dsz or nt % fsz:
        raise ValueError(f"sharded_best_target: {nq} queries over data {dsz}, {nt} targets "
                         f"over feat {fsz}: pad to multiples first")
    dev = q_desc.device
    if p1 is None:
        p1 = p2 = torch.full((nq, 2), torch.inf, dtype=torch.float32, device=dev)
        t_loc = torch.zeros((nt, 2), dtype=torch.float32, device=dev)
    qv = None if q_valid is None else _shard(q_valid, mesh, DATA_AXIS).contiguous()
    li, ld = best_target(_shard(q_desc, mesh, DATA_AXIS).contiguous(),
                         _shard(t_desc, mesh, FEAT_AXIS).contiguous(),
                         _shard(t_loc, mesh, FEAT_AXIS).contiguous(),
                         _shard(p1, mesh, DATA_AXIS).contiguous(),
                         _shard(p2, mesh, DATA_AXIS).contiguous(), epsilon,
                         _shard(t_valid, mesh, FEAT_AXIS).contiguous(), q_valid=qv)
    # globalise the target index, then two MINs over feat: the distance,
    # then the lowest global index among the shards that hold it (the
    # distances are exact integers, so the equality is safe)
    gi = li.to(torch.int64) + axis_rank(mesh, FEAT_AXIS) * (nt // fsz)
    bd = all_reduce(ld, "MIN", mesh, FEAT_AXIS)
    bi = all_reduce(torch.where(ld == bd, gi, _NO_INDEX), "MIN", mesh, FEAT_AXIS)
    return host_value(bi.to(torch.int32), mesh, DATA_AXIS), host_value(bd, mesh, DATA_AXIS)


def _sharded_match(mesh, query: FeatureSet, target: FeatureSet, params: MatchParams,
                   seed_dist, p1=None, p2=None):
    from ssrlcv_tpu_torch.matching.match import _threshold

    dsz, fsz = axis_size(mesh, DATA_AXIS), axis_size(mesh, FEAT_AXIS)
    nq = query.capacity
    gate = {}
    if p1 is not None:
        gate = dict(p1=_pad_to(p1, dsz), p2=_pad_to(p2, dsz), t_loc=_pad_to(target.loc, fsz),
                    epsilon=float(params.epsilon))
    idx, dist = sharded_best_target(mesh, _pad_to(query.descriptors, dsz),
                                    _pad_to(target.descriptors, fsz), _pad_to(target.mask, fsz),
                                    q_valid=_pad_to(query.mask, dsz), **gate)
    return _threshold(idx[:nq], dist[:nq], query.mask, params, seed_dist)


def sharded_match_double_constrained(mesh, query: FeatureSet, target: FeatureSet,
                                     cameras: Cameras, query_index: int, target_index: int,
                                     params: MatchParams,
                                     seed_dist: Optional[torch.Tensor] = None):
    """The sharded twin of ``matching.match.match_double_constrained``:
    the same DMatches (exact integer distances)."""
    from ssrlcv_tpu_torch.core import camera_math

    qi, ti = query_index, target_index
    P = camera_math.projection_matrix(
        cameras.cam_pos[ti], cameras.cam_rot[ti], cameras.foc[ti],
        cameras.dpix[ti], cameras.size[ti], cameras.ecef_offset[ti])
    p1, p2 = camera_math.epipolar_segment_endpoints(
        query.loc, cameras.cam_pos[qi], cameras.cam_rot[qi], cameras.foc[qi],
        cameras.dpix[qi], cameras.size[qi], cameras.ecef_offset[qi], P, params.delta)
    return _sharded_match(mesh, query, target, params, seed_dist, p1, p2)


def sharded_match_brute_force(mesh, query: FeatureSet, target: FeatureSet, params: MatchParams,
                              seed_dist: Optional[torch.Tensor] = None):
    """The sharded twin of ``matching.match.match_brute_force``."""
    return _sharded_match(mesh, query, target, params, seed_dist)


def sharded_generate_features(mesh, pixels, image_ids, sift_params, device=None) -> list:
    """Image-parallel SIFT over the flattened mesh.

    pixels: a sequence of N same-shape grayscale (or RGB) uint8 images;
    image_ids: N ints.  Rank d owns images [d * n_local, (d + 1) * n_local)
    (n_local = ceil(N / ranks)) and runs ``generate_features`` on each on
    ``device`` (None: ``cuda:0``); a rank with fewer images runs no more
    (the padding slots are empty feature sets, not re-runs of image 0).
    The feature sets are then gathered, so every rank returns the same list
    of N FeatureSets, each equal to ``generate_features`` on its image."""
    from ssrlcv_tpu_torch.core.device import resolve_device
    from ssrlcv_tpu_torch.features.sift import generate_features

    dev = resolve_device(device)
    ids = [int(i) for i in image_ids]
    n, nd, r = len(ids), mesh.size(), flat_rank(mesh)
    n_local = -(-n // nd)
    empty = FeatureSet.empty(sift_params.max_keypoints, device=dev)
    mine = [generate_features(pixels[i], sift_params, image_id=ids[i], device=dev)
            if i < n else empty for i in range(r * n_local, (r + 1) * n_local)]
    fields = {}
    for name in FeatureSet.__dataclass_fields__:
        stacked = torch.stack([getattr(f, name) for f in mine])
        fields[name] = torch.cat(all_gather(stacked, mesh))[:n]
    return [FeatureSet(**{k: v[i] for k, v in fields.items()}) for i in range(n)]


def sharded_pairwise_index_matches(mesh, features: list, cameras: Cameras, params: MatchParams,
                                   seed_features: Optional[FeatureSet] = None) -> dict:
    """The N-view pair sweep over every (i < j) pair, dealt round-robin over
    the flattened mesh and gathered: ``tracks.pairwise_index_matches`` with
    ``mesh``."""
    from ssrlcv_tpu_torch.matching.tracks import pairwise_index_matches

    return pairwise_index_matches(features, cameras, params, seed_features, mesh=mesh)


def _allgather_pair_matches(local_out: dict, pairs: list, mesh, device) -> dict:
    """Exchange the per-pair index matches: each rank sends the match
    counts of its pairs and their rows concatenated (padded all-gathers,
    counts first), and every rank rebuilds the full {pair: matches}
    dict, so each builds identical tracks."""
    nd, r = mesh.size(), flat_rank(mesh)
    mine = pairs[r::nd]
    counts = torch.tensor([len(local_out[ij]) for ij in mine], dtype=torch.int64)
    rows = torch.from_numpy(np.concatenate([local_out[ij] for ij in mine])
                            if mine else np.zeros((0, 2), np.int64))
    all_counts = all_gather_ragged(counts.to(device), mesh)
    all_rows = all_gather_ragged(rows.to(device), mesh)
    by_pair = {}
    for p in range(nd):
        ends = np.cumsum(all_counts[p].cpu().numpy())
        theirs = all_rows[p].cpu().numpy()
        for ij, end, c in zip(pairs[p::nd], ends, all_counts[p].tolist()):
            by_pair[ij] = theirs[end - c:end]
    return {ij: by_pair[ij] for ij in pairs}


def _track_shard(mesh, matches: MatchSet) -> MatchSet:
    ms = pad_matchset(matches, axis_size(mesh, DATA_AXIS))
    return MatchSet(**{k: _shard(v, mesh, DATA_AXIS) for k, v in vars(ms).items()})


def sharded_triangulate(mesh, matches: MatchSet, cameras: Cameras):
    """Track-sharded 2-view triangulation: each data rank triangulates its
    block of tracks, the cloud is gathered and the total error summed over
    data; the padding tracks are dropped again.  Returns (PointCloud,
    total error), the same on every rank."""
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import two_view_triangulate

    cap = matches.capacity
    pc, err = two_view_triangulate(generate_bundles(_track_shard(mesh, matches), cameras))
    pc = host_tree(pc, mesh, DATA_AXIS)
    err = all_reduce(err, "SUM", mesh, DATA_AXIS)
    return pc.replace(points=pc.points[:cap], errors=pc.errors[:cap], mask=pc.mask[:cap]), err


def _lm_solve(H, g, lam, free):
    """Damped LM solve with pinned parameters: the linear algebra of
    ``ba.two_view``'s LM step."""
    damped = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
    damped = damped * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    return torch.linalg.solve_ex(damped, g)[0]


def _free_mask(n_cams: int, like: torch.Tensor, fix_camera0: bool) -> torch.Tensor:
    free = torch.ones((n_cams, 6), dtype=like.dtype, device=like.device)
    if fix_camera0:
        free[0] = 0.0
    return free.reshape(-1)


def sharded_ba_step(mesh, matches: MatchSet, cameras: Cameras, params_flat, lam,
                    fix_camera0: bool = True):
    """One sharded LM iteration on the 2-view BA objective: each data
    rank's error, gradient and Hessian over its tracks, summed over data,
    then the (6N)x(6N) damped solve on every rank.  Returns (new flat
    camera state, total error at ``params_flat``)."""
    from ssrlcv_tpu_torch.ba.two_view import make_objective

    obj = make_objective(_track_shard(mesh, matches), cameras)
    m = params_flat.shape[0]
    red = all_reduce(torch.cat([obj(params_flat).reshape(1), grad(obj)(params_flat),
                                hessian(obj)(params_flat).reshape(-1)]), "SUM", mesh, DATA_AXIS)
    free = _free_mask(cameras.num_cameras, params_flat, fix_camera0)
    lam = torch.as_tensor(lam, dtype=params_flat.dtype, device=params_flat.device)
    step = _lm_solve(red[1 + m:].reshape(m, m), red[1:1 + m] * free, lam, free)
    return params_flat - step * free, red[0]


def sharded_bundle_adjust(mesh, matches: MatchSet, cameras: Cameras, iterations: int = 10,
                          fix_camera0: bool = True, initial_lambda: float = 1e-3):
    """Distributed 2-view LM bundle adjustment: the lambda-adaptive loop of
    ``ba.two_view.bundle_adjust_two_view(mode="lm")`` with the error,
    gradient and Hessian summed over data each iteration.  Every decision
    is taken on the summed scalars, so every rank runs the same loop.
    Returns a ``ba.two_view.BAResult``, the same on every rank."""
    from ssrlcv_tpu_torch.ba.two_view import BAResult, _apply_params, make_objective

    n_cams = cameras.num_cameras
    local = make_objective(_track_shard(mesh, matches), cameras)
    grad_fn, hess_fn = grad(local), hessian(local)

    def objective(p):
        return all_reduce(local(p).reshape(1), "SUM", mesh, DATA_AXIS)[0]

    p0 = torch.cat([cameras.cam_pos, cameras.cam_rot], dim=1).reshape(-1)
    free = _free_mask(n_cams, p0, fix_camera0)
    init_err = objective(p0)
    hist = init_err.repeat(iterations + 1)
    best, best_err = p0, init_err
    lam = torch.tensor(initial_lambda, dtype=p0.dtype, device=p0.device)
    done = torch.tensor(False, device=p0.device)
    m = p0.shape[0]
    for i in range(iterations):
        # the gradient and Hessian summed over data in one all-reduce
        red = all_reduce(torch.cat([grad_fn(best), hess_fn(best).reshape(-1)]), "SUM", mesh,
                         DATA_AXIS)
        new = best - _lm_solve(red[m:].reshape(m, m), red[:m] * free, lam, free) * free
        new_err = objective(new)
        improved = new_err < best_err
        live = ~done
        take = improved & live
        best = torch.where(take, new, best)
        best_err = torch.where(take, new_err, best_err)
        lam = torch.where(live, torch.where(improved, lam * 0.3, lam * 10.0), lam)
        hist[i + 1] = torch.where(live, best_err, hist[i + 1])
        done = done | (~improved & (i > 0))

    out_cams = _apply_params(cameras, best.reshape(n_cams, 6))
    cloud, _ = sharded_triangulate(mesh, matches, out_cams)
    return BAResult(out_cams, cloud, init_err, best_err, hist)
