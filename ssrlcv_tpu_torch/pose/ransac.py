"""RANSAC 7-point fundamental-matrix estimation and essential decomposition.

Counterpart of ``ssrlcv_tpu/pose/ransac.py``: the whole candidate
population is one batched SVD, a Newton root solve and a (candidates x
matches) inlier matrix.

  * 7-point nullspace: the last two right-singular vectors F1, F2 of each
    7x9 system; det(x F1 + (1 - x) F2) = 0 solved by 50 Newton steps from
    x = 0;
  * inlier test: symmetric epipolar distance
    (x2^T F x1)^2 / (||F x1||_xy^2 + ||F^T x2||_xy^2) < threshold;
  * E = K^T F K -> four (R, t) candidates; the cheirality vote picks the
    one with the most inliers in front of both cameras.

F1 and F2 are any orthonormal basis of a 2-D nullspace, and another SVD may
return another basis, so Newton may reach another root of the cubic: the
candidates of two implementations agree as consensus sets, not as matrices.
``estimate_pose_from_indices`` solves from a given (C, 7) index array, so
two implementations can be held to the same samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssrlcv_tpu_torch.core.types import Cameras, MatchSet
from ssrlcv_tpu_torch.geometry.triangulation import two_view_midpoints


class RansacResult(NamedTuple):
    F: torch.Tensor            # (3, 3) best fundamental matrix
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor
    R: torch.Tensor            # (3, 3) relative rotation (cheirality winner)
    t: torch.Tensor            # (3,) unit translation


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _cofactors(m: torch.Tensor) -> torch.Tensor:
    """Cofactor matrices: d det(m) / d m."""
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r = [k for k in range(3) if k != i]
            s = [k for k in range(3) if k != j]
            minor = (m[..., r[0], s[0]] * m[..., r[1], s[1]]
                     - m[..., r[0], s[1]] * m[..., r[1], s[0]])
            c[i][j] = minor if (i + j) % 2 == 0 else -minor
    return torch.stack([torch.stack(row, dim=-1) for row in c], dim=-2)


def seven_point_candidates(q: torch.Tensor, t: torch.Tensor, idx: torch.Tensor):
    """F candidates of the 7-match samples ``idx`` (C, 7) of pixel
    locations q, t (N, 2).  Returns (C, 3, 3) F and a (C,) flag: the Newton
    root is a root."""
    q7, t7 = q[idx], t[idx]
    x1, y1 = q7[..., 0], q7[..., 1]
    x2, y2 = t7[..., 0], t7[..., 1]
    # rows [x2 x1, x2 y1, x2, y2 x1, y2 y1, y2, x1, y1, 1] of x2^T F x1 = 0
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)                       # (C, 7, 9)
    Vh = torch.linalg.svd(A, full_matrices=True)[2]
    F1 = Vh[:, 7, :].reshape(-1, 3, 3)
    F2 = Vh[:, 8, :].reshape(-1, 3, 3)

    def mix(x):
        return x[:, None, None] * F1 + (1 - x)[:, None, None] * F2

    x = torch.zeros(F1.shape[0], dtype=F1.dtype, device=F1.device)
    for _ in range(50):
        M = mix(x)
        fpx = torch.sum(_cofactors(M) * (F1 - F2), dim=(-2, -1))
        x = x - _det3(M) / torch.where(torch.abs(fpx) > 1e-20, fpx, 1e-20)
    return mix(x), torch.abs(_det3(mix(x))) < 1e-5


def symmetric_epipolar_sq(F: torch.Tensor, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(C, N) squared symmetric epipolar distance of candidates F (C, 3, 3)."""
    qh = torch.cat([q, torch.ones_like(q[:, :1])], dim=1)
    th = torch.cat([t, torch.ones_like(t[:, :1])], dim=1)
    Fx1 = torch.einsum("cij,nj->cni", F, qh)
    Ftx2 = torch.einsum("cji,nj->cni", F, th)
    num = torch.einsum("ni,cni->cn", th, Fx1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-20)


def decompose_essential(F: torch.Tensor, cameras: Cameras, q: torch.Tensor, t: torch.Tensor,
                        inliers: torch.Tensor):
    """E = K^T F K (camera 0's intrinsics, focal length foc / dpix.x in
    pixels) -> the four (R, t) candidates; returns the one with the most
    inliers in front of both cameras."""
    dt, dev = F.dtype, F.device
    fx = cameras.foc[0] / cameras.dpix[0, 0]
    K = torch.eye(3, dtype=dt, device=dev)
    K[0, 0], K[1, 1] = fx, fx
    K[0, 2] = cameras.size[0, 0].to(dt) / 2.0
    K[1, 2] = cameras.size[0, 1].to(dt) / 2.0
    U, _, Vh = torch.linalg.svd(K.T @ F @ K)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=dt, device=dev)
    R1, R2 = U @ W @ Vh, U @ W.T @ Vh
    tvec = U[:, 2]

    Kinv = torch.linalg.inv(K)
    qn = torch.cat([q, torch.ones_like(q[:, :1])], dim=1) @ Kinv.T
    tn = torch.cat([t, torch.ones_like(t[:, :1])], dim=1) @ Kinv.T

    def cheirality(R, tv):
        # midpoints of the normalised rays; count inliers with positive
        # depth in both cameras
        v1 = qn / torch.linalg.norm(qn, dim=1, keepdim=True)
        v2 = tn @ R
        v2 = v2 / torch.linalg.norm(v2, dim=1, keepdim=True)
        p2 = R.T @ -tv
        s1, s2 = two_view_midpoints(v1, torch.zeros_like(v1), v2, torch.broadcast_to(p2, v2.shape))
        X = (s1 + s2) / 2.0
        z2 = (X @ R.T + tv)[:, 2]
        return torch.sum((X[:, 2] > 0) & (z2 > 0) & inliers)

    votes = torch.stack([cheirality(R1, tvec), cheirality(R1, -tvec),
                         cheirality(R2, tvec), cheirality(R2, -tvec)])
    winner = torch.argmax(votes)
    R = torch.where(winner < 2, R1, R2)
    tv = torch.where(winner % 2 == 0, tvec, -tvec)
    return R, tv


def estimate_pose_from_indices(matches: MatchSet, cameras: Cameras, idx: torch.Tensor,
                               inlier_threshold: float = 0.25) -> RansacResult:
    """RANSAC over the given (C, 7) samples of match indices."""
    q, t = matches.kp_loc[:, 0], matches.kp_loc[:, 1]
    F_cands, ok = seven_point_candidates(q, t, idx)
    inl = (symmetric_epipolar_sq(F_cands, q, t) < inlier_threshold) & matches.mask[None, :]
    counts = torch.sum(inl, dim=1) * ok
    best = torch.argmax(counts)
    F, inliers = F_cands[best], inl[best]
    R, tv = decompose_essential(F, cameras, q, t, inliers)
    return RansacResult(F=F, inliers=inliers, num_inliers=counts[best], R=R, t=tv)


def estimate_pose_ransac(matches: MatchSet, cameras: Cameras, generator: torch.Generator,
                         inlier_threshold: float = 0.25,
                         num_candidates: int = 2048) -> RansacResult:
    """RANSAC with ``num_candidates`` 7-match samples drawn uniformly (with
    repeats, padding slots included, as the JAX sampler) by ``generator``."""
    n = matches.capacity
    idx = torch.randint(0, n, (num_candidates, 7), generator=generator,
                        device=generator.device)
    return estimate_pose_from_indices(matches, cameras, idx.to(matches.kp_loc.device),
                                      inlier_threshold)
