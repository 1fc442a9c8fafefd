"""Two-view bundle adjustment.

Counterpart of ``ssrlcv_tpu/ba/two_view.py``: steps on the 12-dim camera
state (2 cameras x {pos, rot}) against the total linear error, with the
exact gradient and Hessian from ``torch.func.grad`` / ``torch.func.hessian``
and camera 0 pinned.  Where every live slot of a view column has the same
parent, as the 2-view ``MatchSet`` of ``matches_to_matchset`` has, the
objective takes each column's camera row once and broadcasts it over the
tracks: the rays are those of ``generate_bundles`` bit for bit, and the
derivatives sum over the tracks in place of an accumulating index backward
into the camera rows.  Modes:

  * ``"lm"`` (the pipeline's): damped Levenberg-Marquardt steps;
  * ``"newton"``: alpha-scaled Newton steps alpha * H^+ g through an SVD
    pseudo-inverse (singular values <= svd_rcond * max clamped), with the
    error-ratio alpha decay and the first failure's alpha / 100;
  * ``"reference"``: the reference's shipped behaviour with its default
    flags, which never applies an update: the error history is flat and the
    cloud is the input cameras' triangulation.

Every mode keeps the best parameters; once a step fails after the first
iteration the state freezes (the reference leaves its loop); the loop goes
on, and ``accepted`` counts the steps taken.  The loop runs on tensors with
no host synchronisation.  Spans (``logger.span``): ``ba.setup``, each
``ba.iteration`` with its ``ba.grad``, ``ba.hessian``, ``ba.solve`` and
``ba.objective`` (the candidate's error), and ``ba.final`` (the last
triangulation); none inside a function that ``torch.func`` transforms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, hessian

from ssrlcv_tpu_torch.config import BAParams
from ssrlcv_tpu_torch.core import camera_math
from ssrlcv_tpu_torch.core.types import Bundles, Cameras, MatchSet, PointCloud
from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
from ssrlcv_tpu_torch.geometry.triangulation import linear_error_objective, two_view_triangulate
from ssrlcv_tpu_torch.logging import logger

MODES = ("lm", "newton", "reference")


def _apply_params(cameras: Cameras, params: torch.Tensor) -> Cameras:
    """params: (N, 6) [pos(3), rot(3)] absolute camera state."""
    return cameras.replace(cam_pos=params[:, 0:3], cam_rot=params[:, 3:6])


def view_columns(matches: MatchSet):
    """(V,) int64 camera of each view column where every slot of the column
    has that parent or none (-1); a column with no parent at all takes
    camera 0, as ``generate_bundles`` does.  None where a column mixes
    parents, or without tracks.  One host read."""
    parent = matches.kp_parent
    if parent.shape[0] == 0:
        return None
    col = parent.amax(0)
    if not bool(((parent == col) | (parent < 0)).all()):
        return None
    return torch.clamp(col, min=0).to(torch.int64)


def make_objective(matches: MatchSet, cameras: Cameras):
    """Total linear error as a function of the flat (N*6,) camera state.
    The function's ``column_cameras`` says whether it reaches the cameras
    by view column (``view_columns``) or by each slot's parent."""
    n = cameras.num_cameras
    col = view_columns(matches)

    if col is None:
        def objective(p_flat: torch.Tensor) -> torch.Tensor:
            cams = _apply_params(cameras, p_flat.reshape(n, 6))
            return linear_error_objective(generate_bundles(matches, cams))
    else:
        t = matches.kp_loc.shape[0]
        foc, fov_x, size = cameras.foc[col], cameras.fov[col, 0], cameras.size[col]

        def objective(p_flat: torch.Tensor) -> torch.Tensor:
            # each column's camera row broadcast over the tracks: the rays
            # are the row gather's, and each derivative is the same
            # per-track terms summed over the tracks
            state = torch.index_select(p_flat.reshape(n, 6), 0, col)  # (V, 6)
            pos, rot = (state[:, k:k + 3].expand(t, -1, -1) for k in (0, 3))
            vec, pnt = camera_math.pixel_to_ray(matches.kp_loc, pos, rot, foc, fov_x, size)
            return linear_error_objective(Bundles(vec=vec, pnt=pnt, num_views=matches.num_views,
                                                  mask=matches.mask))

    objective.column_cameras = col is not None
    return objective


class BAResult(NamedTuple):
    cameras: Cameras
    cloud: PointCloud
    initial_error: torch.Tensor
    final_error: torch.Tensor
    error_history: torch.Tensor  # (iterations+1,)
    accepted: torch.Tensor       # () int64: the steps taken
    column_cameras: bool = False  # the objective reached the cameras by view column


def bundle_adjust_two_view(matches: MatchSet, cameras: Cameras, iterations: int = 10,
                           initial_alpha: float = 0.1, svd_rcond: float = 1e-6,
                           mode: str = "lm", fix_camera0: bool = True) -> BAResult:
    if mode not in MODES:
        raise ValueError(f"bundle_adjust_two_view: mode must be one of {MODES}, got {mode!r}")
    with logger.span("ba.setup"):
        objective = make_objective(matches, cameras)
        n_cams = cameras.num_cameras
        params0 = torch.cat([cameras.cam_pos, cameras.cam_rot], dim=1).reshape(-1)
        init_err = objective(params0)
        hist = init_err.repeat(iterations + 1)
        dt, dev = params0.dtype, params0.device
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        grad_fn = grad(objective)
        hess_fn = hessian(objective)
        free = torch.ones((n_cams, 6), dtype=dt, device=dev)
        if fix_camera0:
            free[0] = 0.0
        free = free.reshape(-1)
        pin = torch.diag(1.0 - free)
        free2 = free[:, None] * free[None, :]
    if mode == "reference":
        with logger.span("ba.final"):
            cloud, _ = two_view_triangulate(generate_bundles(matches, cameras))
        return BAResult(cameras, cloud, init_err, init_err, hist, accepted,
                        objective.column_cameras)

    def derivatives(params):
        with logger.span("ba.grad"):
            g = grad_fn(params) * free
        with logger.span("ba.hessian"):
            H = hess_fn(params)
        return g, H

    def lm_step(params, alpha, lam):
        g, H = derivatives(params)
        with logger.span("ba.solve"):
            damped = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
            # pin camera 0 rows/cols to identity so the solve is well-posed
            damped = damped * free2 + pin
            return params - torch.linalg.solve_ex(damped, g)[0] * free

    def newton_step(params, alpha, lam):
        g, H = derivatives(params)
        with logger.span("ba.solve"):
            U, S, Vh = torch.linalg.svd(H, full_matrices=False)
            s_inv = torch.where(S > svd_rcond * torch.max(S), 1.0 / S, 0.0)
            step = (Vh.T * s_inv[None, :]) @ (U.T @ g)
            return params - alpha * (step * free)

    step_fn = lm_step if mode == "lm" else newton_step
    best_params, best_err, prev_err = params0, init_err, init_err
    alpha = torch.tensor(initial_alpha, dtype=dt, device=dev)
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    done = torch.tensor(False, device=dev)
    for i in range(iterations):
        with logger.span("ba.iteration"):
            new_params = step_fn(best_params, alpha, lam)
            with logger.span("ba.objective"):
                new_err = objective(new_params)
            improved = new_err < best_err
            live = ~done
            take = improved & live
            # alpha decays by the error ratio; a first-iteration failure
            # divides it by 100; lambda adapts as in LM
            ratio = torch.where(new_err > 0, prev_err / torch.clamp(new_err, min=1e-30), 1.0)
            alpha2 = alpha / torch.clamp(ratio, min=1e-12) if i > 0 else alpha
            alpha_new = torch.where(improved, alpha2, alpha / 100.0 if i == 0 else alpha)
            best_params = torch.where(take, new_params, best_params)
            best_err = torch.where(take, new_err, best_err)
            prev_err = torch.where(take, new_err, prev_err)
            accepted += take
            alpha = torch.where(live, alpha_new, alpha)
            lam = torch.where(live, torch.where(improved, lam * 0.3, lam * 10.0), lam)
            hist[i + 1] = torch.where(live, best_err, hist[i + 1])
            done = done | (~improved & (i > 0))

    with logger.span("ba.final"):
        out_cams = _apply_params(cameras, best_params.reshape(n_cams, 6))
        cloud, _ = two_view_triangulate(generate_bundles(matches, out_cams))
    return BAResult(out_cams, cloud, init_err, best_err, hist, accepted, objective.column_cameras)


def bundle_adjust(matches: MatchSet, cameras: Cameras, params: BAParams,
                  mode: str = "lm") -> BAResult:
    """Config-driven entry point: iterations, alpha, rcond and the pinned
    camera from ``params``."""
    return bundle_adjust_two_view(matches, cameras, iterations=params.iterations,
                                  initial_alpha=params.initial_alpha,
                                  svd_rcond=params.svd_rcond, mode=mode,
                                  fix_camera0=params.fixed_camera)
