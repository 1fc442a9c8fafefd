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

On the card, a call that runs an iteration captures its problem's ``grad``
and ``hessian`` once, as two CUDA graphs on a buffer of the state's shape
(``graphed``), and every iteration copies its state into that buffer and
replays them: the same kernels on the same shapes, so the same results to
the bit, for one host dispatch a call.  The solve, the candidate's error,
the sums over ranks and the loop's bookkeeping stay eager; the graphs and
their memory pool are released when the loop ends.  CPU tensors, and a
problem whose derivatives wait for the card (not ``capturable``), take them
eagerly.

Spans: ``ba.setup`` (with ``ba.capture`` where the graphs are captured),
each ``ba.iteration`` with its ``ba.grad``, ``ba.hessian``, ``ba.solve``
and ``ba.objective`` (the candidate's error), and ``ba.final`` (the last
triangulation); none inside a function that ``torch.func`` transforms or a
graph captures.  A sharded problem sums the gradient and Hessian over its
ranks between ``ba.hessian`` and ``ba.solve``.
"""

from __future__ import annotations

import contextlib
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
    graphed: bool = False         # the derivatives replayed CUDA graphs


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
    # False where a derivative waits for the card, which no CUDA graph can hold
    capturable: bool = True
    graphed: bool = False         # grad and hessian replay CUDA graphs (``graphed``)


# the side stream each device's captures run on, kept for the process: the
# allocator caches freed memory by the stream that allocated it, and a new
# stream a call reserved 2 MiB more with each call
_capture_streams: dict = {}


class _Replay:
    """``fn`` captured once as a CUDA graph on the buffer ``x``, its
    memory in ``pool``: each call copies the state into ``x``, replays the
    graph and returns its output, which the next call overwrites."""

    def __init__(self, fn: Callable, x: torch.Tensor, pool):
        stream = _capture_streams.get(x.device)
        if stream is None:
            stream = _capture_streams[x.device] = torch.cuda.Stream(x.device)
        self.x, self.graph = x, torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool.id)
            try:
                self.out = fn(x)
            finally:
                self.graph.capture_end()

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        self.x.copy_(p)
        self.graph.replay()
        return self.out

    def release(self):
        self.graph = self.out = None


@contextlib.contextmanager
def graphed(problem: Problem, p0: torch.Tensor, iterations: int):
    """``problem`` with its ``grad`` and ``hessian`` replaying CUDA graphs
    captured at ``p0``'s shape; ``problem`` itself on the CPU, for a loop of
    no iteration, or where it is not ``capturable``.  On exit the graphs,
    their outputs and their memory pool are released."""
    if p0.device.type != "cuda" or iterations < 1 or not problem.capturable:
        yield problem
        return
    with logger.span("ba.capture"), torch.cuda.device(p0.device):
        pool, x = torch.cuda.MemPool(), p0.clone()
        grad, hessian = _Replay(problem.grad, x, pool), _Replay(problem.hessian, x, pool)
    try:
        yield problem._replace(grad=grad, hessian=hessian, graphed=True)
    finally:
        # the graphs and what they hold first, so the pool's memory is free
        grad.release()
        hessian.release()
        del pool


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
    lam = torch.full((), 1e-3, dtype=p0.dtype, device=p0.device)
    done = torch.zeros((), dtype=torch.bool, device=p0.device) if problem.freeze else None
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
    (Levenberg-Marquardt unless given another) with its derivatives
    ``graphed``, and the cloud is the problem's triangulation at the cameras
    of the best state."""
    with contextlib.ExitStack() as graphs:
        with logger.span("ba.setup"):
            p0 = pack(cameras)
            free = free_params(cameras.num_cameras, p0, fix_camera0)
            problem = graphs.enter_context(graphed(setup(p0), p0, iterations))
        best, best_err, hist, accepted = loop(problem, p0, free, iterations)
    with logger.span("ba.final"):
        out = unpack(cameras, best)
        cloud = problem.cloud(out)
    return BAResult(out, cloud, problem.initial_error, best_err, hist, accepted,
                    problem.column_cameras, problem.graphed)
