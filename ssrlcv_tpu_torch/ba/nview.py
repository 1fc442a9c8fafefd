"""N-view bundle adjustment.

Counterpart of ``ssrlcv_tpu/ba/nview.py``: damped Newton (Levenberg-
Marquardt) steps on all N cameras' 6-dof parameters, camera 0 pinned,
against the total N-view error (the sum over tracks of the mean squared
point-line distance after least-squares triangulation), with the exact
gradient and Hessian from ``torch.func``.  The (6N)^2 Hessian stays small:
the least-squares triangulation is itself the elimination of the points.

The objective has a degenerate minimum: a track whose system turns singular
drops out of the sum, so rotating cameras until rays are parallel "wins".
A candidate that loses valid tracks therefore pays 1e6 per track lost; the
penalty is piecewise constant, so it only vetoes a step.  A step whose error
is not finite is never taken either.  The loop runs on tensors with no host
synchronisation; ``accepted`` counts the steps taken.  Its spans are
two-view BA's (``ba/two_view.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, hessian

from ssrlcv_tpu_torch.config import BAParams
from ssrlcv_tpu_torch.core.types import Cameras, MatchSet, PointCloud
from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
from ssrlcv_tpu_torch.geometry.triangulation import n_view_triangulate
from ssrlcv_tpu_torch.logging import logger


class NViewBAResult(NamedTuple):
    cameras: Cameras
    cloud: PointCloud
    initial_error: torch.Tensor
    final_error: torch.Tensor
    accepted: torch.Tensor  # () int64: the steps taken


def _cameras(cameras: Cameras, p: torch.Tensor) -> Cameras:
    q = p.reshape(cameras.num_cameras, 6)
    return cameras.replace(cam_pos=q[:, 0:3], cam_rot=q[:, 3:6])


def bundle_adjust_nview(matches: MatchSet, cameras: Cameras, params: BAParams) -> NViewBAResult:
    def raw(p):
        pc, total = n_view_triangulate(generate_bundles(matches, _cameras(cameras, p)))
        return total, torch.sum(pc.mask.to(torch.float32))

    def objective(p):
        return raw(p)[0]

    with logger.span("ba.setup"):
        n_cams = cameras.num_cameras
        p0 = torch.cat([cameras.cam_pos, cameras.cam_rot], dim=1).reshape(-1)
        free = torch.ones((n_cams, 6), dtype=p0.dtype, device=p0.device)
        if params.fixed_camera:
            free[0] = 0.0
        free = free.reshape(-1)
        pin = torch.diag(1.0 - free)
        free2 = free[:, None] * free[None, :]
        grad_fn, hess_fn = grad(objective), hessian(objective)
        init_err, n_valid0 = raw(p0)
        best_p, best_e = p0, init_err
        lam = torch.tensor(1e-3, dtype=p0.dtype, device=p0.device)
        accepted = torch.zeros((), dtype=torch.int64, device=p0.device)
    for _ in range(params.iterations):
        with logger.span("ba.iteration"):
            with logger.span("ba.grad"):
                g = grad_fn(best_p) * free
            with logger.span("ba.hessian"):
                H = hess_fn(best_p)
            with logger.span("ba.solve"):
                damped = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
                damped = damped * free2 + pin
                cand = best_p - torch.linalg.solve_ex(damped, g)[0] * free
            with logger.span("ba.objective"):
                e, nv = raw(cand)
            e = e + 1e6 * torch.clamp(n_valid0 - nv, min=0.0)
            ok = e < best_e
            best_p = torch.where(ok, cand, best_p)
            best_e = torch.where(ok, e, best_e)
            lam = torch.where(ok, lam * 0.3, lam * 10.0)
            accepted += ok

    with logger.span("ba.final"):
        out_cams = _cameras(cameras, best_p)
        cloud, _ = n_view_triangulate(generate_bundles(matches, out_cams))
    return NViewBAResult(cameras=out_cams, cloud=cloud, initial_error=init_err,
                         final_error=best_e, accepted=accepted)
