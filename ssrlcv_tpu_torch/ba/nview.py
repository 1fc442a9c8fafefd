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
is not finite is never taken either.  The loop is ``ba.lm``'s, with no
freeze; the initial error carries no penalty.  Its derivatives stay eager
on the card: no CUDA graph captures them (the problem's ``capturable``).
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian

from ssrlcv_tpu_torch.ba import lm
from ssrlcv_tpu_torch.config import BAParams
from ssrlcv_tpu_torch.core.types import Cameras, MatchSet
from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
from ssrlcv_tpu_torch.geometry.triangulation import n_view_triangulate


def bundle_adjust_nview(matches: MatchSet, cameras: Cameras, params: BAParams) -> lm.BAResult:
    def raw(p):
        pc, total = n_view_triangulate(generate_bundles(matches, lm.unpack(cameras, p)))
        return total, torch.sum(pc.mask.to(torch.float32))

    def objective(p):
        return raw(p)[0]

    def setup(p0):
        init_err, n_valid0 = raw(p0)

        def error(p):
            e, nv = raw(p)
            return e + 1e6 * torch.clamp(n_valid0 - nv, min=0.0)

        # not capturable: under torch.func the triangulation's solve is
        # differentiated with grad mode on, where PyTorch re-solves with
        # the checked torch.linalg.solve, which waits for the card
        return lm.Problem(init_err, error, grad(objective), hessian(objective),
                          cloud=lambda cams: n_view_triangulate(generate_bundles(matches, cams))[0],
                          freeze=False, capturable=False)

    return lm.adjust(cameras, setup, params.iterations, params.fixed_camera)
