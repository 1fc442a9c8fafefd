"""Two-view bundle adjustment.

Counterpart of ``ssrlcv_tpu/ba/two_view.py``: steps on the 12-dim camera
state (2 cameras x {pos, rot}, ``ba.lm.pack``) against the total linear
error, with the exact gradient and Hessian from ``torch.func.grad`` /
``torch.func.hessian`` and camera 0 pinned.  Where every live slot of a view
column has the same parent, as the 2-view ``MatchSet`` of
``matches_to_matchset`` has, the objective takes each column's camera row
once and broadcasts it over the tracks: the rays are those of
``generate_bundles`` bit for bit, and the derivatives sum over the tracks in
place of an accumulating index backward into the camera rows.  Modes:

  * ``"lm"`` (the pipeline's): the Levenberg-Marquardt loop of ``ba.lm``;
  * ``"newton"``: alpha-scaled Newton steps alpha * H^+ g through an SVD
    pseudo-inverse (singular values <= svd_rcond * max clamped), with the
    error-ratio alpha decay and the first failure's alpha / 100;
  * ``"reference"``: the reference's shipped behaviour with its default
    flags, which never applies an update: the loop runs no step, the error
    history is flat and the cloud is the input cameras' triangulation.

Every mode keeps the best parameters; once a step fails after the first
iteration the state freezes (the reference leaves its loop); the loop goes
on, and ``accepted`` counts the steps taken.  The spans are ``ba.lm``'s, the
Newton loop's too.
"""

from __future__ import annotations

import functools

import torch
from torch.func import grad, hessian

from ssrlcv_tpu_torch.ba import lm
from ssrlcv_tpu_torch.config import BAParams
from ssrlcv_tpu_torch.core import camera_math
from ssrlcv_tpu_torch.core.types import Bundles, Cameras, MatchSet
from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
from ssrlcv_tpu_torch.geometry.triangulation import linear_error_objective, two_view_triangulate
from ssrlcv_tpu_torch.logging import logger

MODES = ("lm", "newton", "reference")


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
            return linear_error_objective(generate_bundles(matches, lm.unpack(cameras, p_flat)))
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


def _newton(initial_alpha: float, svd_rcond: float, problem: lm.Problem, p0: torch.Tensor,
            free: lm.FreeParams, iterations: int):
    """Mode "newton"'s loop, in ``lm.levenberg_marquardt``'s place: alpha
    for lambda; the state frozen after the first failed step past
    iteration 0."""
    best, best_err = p0, problem.initial_error
    hist = best_err.repeat(iterations + 1)
    accepted = torch.zeros((), dtype=torch.int64, device=p0.device)
    alpha = torch.full((), initial_alpha, dtype=p0.dtype, device=p0.device)
    done = torch.zeros((), dtype=torch.bool, device=p0.device)
    for i in range(iterations):
        with logger.span("ba.iteration"):
            g, H = lm.derivatives(problem, best)
            with logger.span("ba.solve"):
                U, S, Vh = torch.linalg.svd(H, full_matrices=False)
                s_inv = torch.where(S > svd_rcond * torch.max(S), 1.0 / S, 0.0)
                step = (Vh.T * s_inv[None, :]) @ (U.T @ (g * free.mask))
                new = best - alpha * (step * free.mask)
            with logger.span("ba.objective"):
                new_err = problem.error(new)
            improved = new_err < best_err
            live = ~done
            take = improved & live
            # alpha decays by the error ratio to the best error; a
            # first-iteration failure divides it by 100
            if i > 0:
                ratio = torch.where(new_err > 0, best_err / torch.clamp(new_err, min=1e-30),
                                    1.0)
                alpha_new = torch.where(improved, alpha / torch.clamp(ratio, min=1e-12), alpha)
            else:
                alpha_new = torch.where(improved, alpha, alpha / 100.0)
            best = torch.where(take, new, best)
            best_err = torch.where(take, new_err, best_err)
            accepted += take
            alpha = torch.where(live, alpha_new, alpha)
            hist[i + 1] = torch.where(live, best_err, hist[i + 1])
            done = done | (~improved & (i > 0))
    return best, best_err, hist, accepted


def bundle_adjust_two_view(matches: MatchSet, cameras: Cameras, iterations: int = 10,
                           initial_alpha: float = 0.1, svd_rcond: float = 1e-6,
                           mode: str = "lm", fix_camera0: bool = True) -> lm.BAResult:
    if mode not in MODES:
        raise ValueError(f"bundle_adjust_two_view: mode must be one of {MODES}, got {mode!r}")

    def cloud(cams):
        return two_view_triangulate(generate_bundles(matches, cams))[0]

    def setup(p0):
        objective = make_objective(matches, cameras)
        return lm.Problem(objective(p0), objective, grad(objective), hessian(objective), cloud,
                          freeze=True, column_cameras=objective.column_cameras)

    if mode == "reference":
        r = lm.adjust(cameras, setup, 0, fix_camera0)
        return r._replace(error_history=r.initial_error.repeat(iterations + 1))
    loop = (functools.partial(_newton, initial_alpha, svd_rcond) if mode == "newton"
            else lm.levenberg_marquardt)
    return lm.adjust(cameras, setup, iterations, fix_camera0, loop)


def bundle_adjust(matches: MatchSet, cameras: Cameras, params: BAParams,
                  mode: str = "lm") -> lm.BAResult:
    """Config-driven entry point: iterations, alpha, rcond and the pinned
    camera from ``params``."""
    return bundle_adjust_two_view(matches, cameras, iterations=params.iterations,
                                  initial_alpha=params.initial_alpha,
                                  svd_rcond=params.svd_rcond, mode=mode,
                                  fix_camera0=params.fixed_camera)
