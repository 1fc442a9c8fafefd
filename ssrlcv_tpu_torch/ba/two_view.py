"""Two-view bundle adjustment, Levenberg-Marquardt mode.

Counterpart of ``ssrlcv_tpu/ba/two_view.py::bundle_adjust_two_view`` with
``mode="lm"``: damped Newton steps on the 12-dim camera state (2 cameras x
{pos, rot}) against the total linear error, with the exact gradient and
Hessian from ``torch.func.grad`` / ``torch.func.hessian``, camera 0 pinned,
best-parameter tracking and lambda adaptation.  The loop runs on tensors
with no host synchronisation: once a step fails after the first iteration
the state freezes, as the JAX loop does.  The ``newton`` and ``reference``
modes are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, hessian

from ssrlcv_tpu_torch.core.types import Cameras, MatchSet, PointCloud
from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
from ssrlcv_tpu_torch.geometry.triangulation import linear_error_objective, two_view_triangulate


def _apply_params(cameras: Cameras, params: torch.Tensor) -> Cameras:
    """params: (N, 6) [pos(3), rot(3)] absolute camera state."""
    return cameras.replace(cam_pos=params[:, 0:3], cam_rot=params[:, 3:6])


def make_objective(matches: MatchSet, cameras: Cameras):
    """Total linear error as a function of the flat (N*6,) camera state."""
    n = cameras.num_cameras

    def objective(p_flat: torch.Tensor) -> torch.Tensor:
        cams = _apply_params(cameras, p_flat.reshape(n, 6))
        return linear_error_objective(generate_bundles(matches, cams))

    return objective


class BAResult(NamedTuple):
    cameras: Cameras
    cloud: PointCloud
    initial_error: torch.Tensor
    final_error: torch.Tensor
    error_history: torch.Tensor  # (iterations+1,)


def bundle_adjust_two_view(matches: MatchSet, cameras: Cameras, iterations: int = 10,
                           mode: str = "lm", fix_camera0: bool = True) -> BAResult:
    if mode != "lm":
        raise NotImplementedError(f"bundle_adjust_two_view: mode {mode!r} is not ported; "
                                  "only 'lm' is")
    objective = make_objective(matches, cameras)
    grad_fn = grad(objective)
    hess_fn = hessian(objective)

    n_cams = cameras.num_cameras
    params0 = torch.cat([cameras.cam_pos, cameras.cam_rot], dim=1).reshape(-1)
    init_err = objective(params0)
    free = torch.ones((n_cams, 6), dtype=params0.dtype, device=params0.device)
    if fix_camera0:
        free[0] = 0.0
    free = free.reshape(-1)
    pin = torch.diag(1.0 - free)
    free2 = free[:, None] * free[None, :]

    best_params, best_err = params0, init_err
    lam = torch.tensor(1e-3, dtype=params0.dtype, device=params0.device)
    done = torch.tensor(False, device=params0.device)
    hist = init_err.repeat(iterations + 1)
    for i in range(iterations):
        g = grad_fn(best_params) * free
        H = hess_fn(best_params)
        damped = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
        # pin camera 0 rows/cols to identity so the solve is well-posed
        damped = damped * free2 + pin
        step = torch.linalg.solve(damped, g)
        new_params = best_params - step * free
        new_err = objective(new_params)
        improved = new_err < best_err
        live = ~done
        # a failed step keeps the best state; a failure after the first
        # iteration ends the loop (the state freezes)
        take = improved & live
        best_params = torch.where(take, new_params, best_params)
        best_err = torch.where(take, new_err, best_err)
        lam = torch.where(live, torch.where(improved, lam * 0.3, lam * 10.0), lam)
        hist[i + 1] = torch.where(live, best_err, hist[i + 1])
        done = done | (~improved & (i > 0))

    out_cams = _apply_params(cameras, best_params.reshape(n_cams, 6))
    cloud, _ = two_view_triangulate(generate_bundles(matches, out_cams))
    return BAResult(out_cams, cloud, init_err, best_err, hist)
