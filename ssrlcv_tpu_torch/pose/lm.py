"""Levenberg-Marquardt relative-pose refinement.

Counterpart of ``ssrlcv_tpu/pose/lm.py``.  The residual per match is the
skew-line closest-point gap (s1 - s2, 0) in the relative frame (query camera
at the origin with identity rotation, target at the pose's position and
Euler rotation).  The reference differentiates it by central differences
and zeroes the position columns of J, so only the rotation is optimised;
here the rotation block comes from ``torch.func.jacfwd``.

Schedule: JTJ + lambda * I through an eigen-decomposition pseudo-inverse
(eigenvalues <= 1e-4 clamped), delta = -JTJ^+ JTf; on rejection lambda *= 2
(at most ``max_inner`` tries), on acceptance lambda /= 4; at most
``max_outer`` outer iterations, and the loop ends at the first outer step
that accepts nothing.  The inner tries are batched: all ``max_inner``
candidates lambda * 2^k are solved with one batched ``eigh`` and costed in
one pass, and the first that lowers the cost wins, as the sequential search
would pick it.  The outer loop checks on the host, once per step, whether a
candidate was accepted: the loop usually ends after a few steps, and a fixed
loop with a frozen state would spend all ``max_outer`` steps' work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ssrlcv_tpu_torch.config import PoseParams
from ssrlcv_tpu_torch.core import camera_math
from ssrlcv_tpu_torch.core.types import Cameras, MatchSet
from ssrlcv_tpu_torch.geometry.triangulation import two_view_midpoints


class Pose(NamedTuple):
    """roll / pitch / yaw and position (position in 1/1000 km, as the
    reference stores it)."""

    rot: torch.Tensor  # (3,)
    pos: torch.Tensor  # (3,)


def _ray(loc, dpix, foc, size):
    """Image-plane direction of pixel locations (N, 2) in the camera frame."""
    return torch.stack([dpix[0] * (loc[:, 0] - size[0] / 2.0),
                        dpix[1] * (loc[:, 1] - size[1] / 2.0),
                        torch.broadcast_to(foc, loc[:, 0].shape)], dim=-1)


def _residuals(rot, pos, q_loc, t_loc, q_dpix, q_foc, q_size, t_dpix, t_foc, t_size):
    """(N, 4) skew-line gap residuals."""
    qvec = _ray(q_loc, q_dpix, q_foc, q_size)
    qvec = qvec / torch.linalg.norm(qvec, dim=-1, keepdim=True)
    tvec = camera_math.rotate_point(_ray(t_loc, t_dpix, t_foc, t_size), rot)
    tvec = tvec / torch.linalg.norm(tvec, dim=-1, keepdim=True)
    s1, s2 = two_view_midpoints(qvec, torch.zeros_like(qvec), tvec,
                                torch.broadcast_to(pos, tvec.shape))
    gap = s1 - s2
    return torch.cat([gap, torch.zeros_like(gap[:, :1])], dim=1)


def lm_optimize(matches: MatchSet, cameras: Cameras, params: PoseParams) -> Pose:
    """The LM loop on a 2-view match set, from the cameras' telemetry: the
    relative rotation R0^T R1 and the position difference de-rotated by the
    query's Euler angles in z, y, x order, / 1000."""
    dev, dt = cameras.cam_rot.device, cameras.cam_rot.dtype
    q_rot = cameras.cam_rot[0]
    R0 = camera_math.rotation_matrix(cameras.cam_rot[0])
    R1 = camera_math.rotation_matrix(cameras.cam_rot[1])
    rot = camera_math.axis_rotations(R0.T @ R1)
    pos = cameras.cam_pos[1] - cameras.cam_pos[0]
    for k in (2, 1, 0):
        axis = torch.zeros(3, dtype=dt, device=dev)
        axis[k] = 1.0
        pos = camera_math.rotate_point_arbitrary(pos, axis, -q_rot[k])
    pos = pos / 1000.0

    size = cameras.size.to(dt)
    q_loc, t_loc, mask = matches.kp_loc[:, 0], matches.kp_loc[:, 1], matches.mask
    fixed = (q_loc, t_loc, cameras.dpix[0], cameras.foc[0], size[0],
             cameras.dpix[1], cameras.foc[1], size[1])

    def res_fn(r, p):
        return torch.where(mask[:, None], _residuals(r, p, *fixed), 0.0)

    def cost_fn(r, p):
        res = res_fn(r, p)
        return torch.sum(res * res)

    max_inner = params.max_inner_iterations
    lam = torch.tensor(params.initial_lambda, dtype=torch.float32, device=dev)
    eye = torch.eye(6, dtype=dt, device=dev)
    steps = 2.0 ** torch.arange(max_inner, dtype=torch.float32, device=dev)
    for _ in range(params.max_outer_iterations):
        r = res_fn(rot, pos)
        j_rot = jacfwd(lambda rr: res_fn(rr, pos))(rot)               # (N, 4, 3)
        Jf = torch.cat([j_rot, torch.zeros_like(j_rot)], dim=2).reshape(-1, 6)
        rf = r.reshape(-1)
        JTJ0 = Jf.T @ Jf
        JTf = Jf.T @ rf
        cost = torch.sum(rf * rf)
        lams = lam * steps
        S, V = torch.linalg.eigh(JTJ0 + lams[:, None, None] * eye)     # (I, 6), (I, 6, 6)
        s_inv = torch.where(S > 1e-4, 1.0 / S, 0.0)
        deltas = -((V * s_inv[:, None, :]) @ (V.transpose(1, 2) @ JTf)[..., None])[..., 0]
        cand_rot = rot[None, :] + deltas[:, 0:3]
        cand_pos = pos[None, :] + deltas[:, 3:6]
        ok = vmap(cost_fn)(cand_rot, cand_pos) < cost
        k = int(torch.argmax(ok.to(torch.int32)))                      # the first acceptance
        if not bool(ok[k]):
            break
        rot, pos = cand_rot[k], cand_pos[k]
        # each rejection doubled lambda; the acceptance divides it by 4
        lam = lams[k] / 4.0
    return Pose(rot=rot, pos=pos)


def apply_pose(cameras: Cameras, pose: Pose) -> Cameras:
    """Write the relative pose into camera 1: pos1 = pos0 + R(rot0) @
    (1000 * pose.pos), R1 = R(rot0) @ R(pose.rot)."""
    new_pos = cameras.cam_pos[0] + camera_math.rotate_point(1000.0 * pose.pos,
                                                            cameras.cam_rot[0])
    R = camera_math.rotation_matrix(cameras.cam_rot[0]) @ camera_math.rotation_matrix(pose.rot)
    cam_pos, cam_rot = cameras.cam_pos.clone(), cameras.cam_rot.clone()
    cam_pos[1] = new_pos
    cam_rot[1] = camera_math.axis_rotations(R)
    return cameras.replace(cam_pos=cam_pos, cam_rot=cam_rot)


def refine_relative_pose(matches: MatchSet, cameras: Cameras, params: PoseParams) -> Cameras:
    """The pipeline's pose stage: LM on the 2-view match set, then the pose
    written into camera 1."""
    return apply_pose(cameras, lm_optimize(matches, cameras, params))
