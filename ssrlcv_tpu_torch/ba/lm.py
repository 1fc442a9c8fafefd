"""The camera state of the port's bundle adjustments and the one
Levenberg-Marquardt loop that steps it.

The state is the flat (N*6,) vector of [pos(3), rot(3)] per camera
(``pack`` / ``unpack``), camera 0's six pinned or not (``free_params``).
2-view, N-view and sharded 2-view BA (``ba.two_view``, ``ba.nview``,
``parallel.sharded``) each make a ``Problem`` and ``adjust`` steps it: each
iteration solves ``H + lam * diag(max(diag H, 1e-8))``, pinned rows and
columns set to the identity (``damped_solve``), and takes the step where the
candidate's error is below the best; lambda is multiplied by 0.3 on a step
taken and by 10 on one refused.  A problem that freezes stops once a step
fails after iteration 0 (the reference leaves its loop there): the loop goes
on, takes nothing, and the history's later entries keep the initial error.
No host synchronisation; ``accepted`` counts the steps taken.

Spans: ``ba.setup``, each ``ba.iteration`` with its ``ba.grad``,
``ba.hessian``, ``ba.solve`` and ``ba.objective`` (the candidate's error),
and ``ba.final`` (the last triangulation); none inside a function that
``torch.func`` transforms.  A sharded problem sums the gradient and Hessian
over its ranks between ``ba.hessian`` and ``ba.solve``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ssrlcv_tpu_torch.core.types import Cameras, PointCloud
from ssrlcv_tpu_torch.logging import logger


def pack(cameras: Cameras) -> torch.Tensor:
    """The (N*6,) state [pos(3), rot(3)] of each camera."""
    return torch.cat([cameras.cam_pos, cameras.cam_rot], dim=1).reshape(-1)


def unpack(cameras: Cameras, p: torch.Tensor) -> Cameras:
    """``cameras`` at the state ``p`` (views of it, so ``torch.func``
    differentiates through them)."""
    q = p.reshape(cameras.num_cameras, 6)
    return cameras.replace(cam_pos=q[:, 0:3], cam_rot=q[:, 3:6])


class FreeParams(NamedTuple):
    mask: torch.Tensor   # (N*6,) 1 where a parameter moves, 0 where it is pinned
    outer: torch.Tensor  # mask[:, None] * mask[None, :]
    pin: torch.Tensor    # diag(1 - mask)


def free_params(n_cams: int, like: torch.Tensor, fix_camera0: bool) -> FreeParams:
    """Every parameter of ``n_cams`` cameras free, or all but camera 0's."""
    mask = torch.ones((n_cams, 6), dtype=like.dtype, device=like.device)
    if fix_camera0:
        mask[0] = 0.0
    mask = mask.reshape(-1)
    return FreeParams(mask, mask[:, None] * mask[None, :], torch.diag(1.0 - mask))


def damped_solve(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor,
                 free: FreeParams) -> torch.Tensor:
    """The LM step for gradient ``g`` and Hessian ``H``: zero at the pinned
    parameters, whose rows and columns are the identity in the solve."""
    g = g * free.mask
    damped = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
    damped = damped * free.outer + free.pin
    return torch.linalg.solve_ex(damped, g)[0] * free.mask


class BAResult(NamedTuple):
    cameras: Cameras
    cloud: PointCloud
    initial_error: torch.Tensor
    final_error: torch.Tensor
    error_history: torch.Tensor   # (iterations+1,)
    accepted: torch.Tensor        # () int64: the steps taken
    column_cameras: bool = False  # 2-view: the objective reached the cameras by view column


def _one_rank(g, H):
    return g, H


class Problem(NamedTuple):
    """A bundle adjustment's side of the loop, made in ``ba.setup``."""
    initial_error: torch.Tensor
    error: Callable    # state -> the error a candidate is judged on
    grad: Callable     # state -> gradient
    hessian: Callable  # state -> Hessian
    cloud: Callable    # Cameras -> PointCloud: the final triangulation
    freeze: bool       # stop at the first failed step after iteration 0
    column_cameras: bool = False
    summed: Callable = _one_rank  # (g, H) -> both summed over the ranks' shards


def derivatives(problem: Problem, p: torch.Tensor):
    """(gradient, Hessian) of ``problem`` at ``p``."""
    with logger.span("ba.grad"):
        g = problem.grad(p)
    with logger.span("ba.hessian"):
        H = problem.hessian(p)
    return problem.summed(g, H)


def levenberg_marquardt(problem: Problem, p0: torch.Tensor, free: FreeParams, iterations: int):
    """(best state, its error, error history, steps taken)."""
    best, best_err = p0, problem.initial_error
    hist = best_err.repeat(iterations + 1)
    accepted = torch.zeros((), dtype=torch.int64, device=p0.device)
    lam = torch.tensor(1e-3, dtype=p0.dtype, device=p0.device)
    done = torch.tensor(False, device=p0.device) if problem.freeze else None
    for i in range(iterations):
        with logger.span("ba.iteration"):
            g, H = derivatives(problem, best)
            with logger.span("ba.solve"):
                new = best - damped_solve(H, g, lam, free)
            with logger.span("ba.objective"):
                new_err = problem.error(new)
            improved = new_err < best_err
            lam_next = torch.where(improved, lam * 0.3, lam * 10.0)
            if problem.freeze:
                live = ~done
                take, lam = improved & live, torch.where(live, lam_next, lam)
                done = done | (~improved & (i > 0))
            else:
                take, lam = improved, lam_next
            best = torch.where(take, new, best)
            best_err = torch.where(take, new_err, best_err)
            accepted += take
            hist[i + 1] = torch.where(live, best_err, hist[i + 1]) if problem.freeze else best_err
    return best, best_err, hist, accepted


def adjust(cameras: Cameras, setup: Callable, iterations: int, fix_camera0: bool,
           loop: Callable = levenberg_marquardt) -> BAResult:
    """Bundle adjustment of ``cameras``: ``setup(p0)`` makes the ``Problem``
    at their state ``p0``, ``loop(problem, p0, free, iterations)`` steps it
    (Levenberg-Marquardt unless given another), and the cloud is the
    problem's triangulation at the cameras of the best state."""
    with logger.span("ba.setup"):
        p0 = pack(cameras)
        free = free_params(cameras.num_cameras, p0, fix_camera0)
        problem = setup(p0)
    best, best_err, hist, accepted = loop(problem, p0, free, iterations)
    with logger.span("ba.final"):
        out = unpack(cameras, best)
        cloud = problem.cloud(out)
    return BAResult(out, cloud, problem.initial_error, best_err, hist, accepted,
                    problem.column_cameras)
