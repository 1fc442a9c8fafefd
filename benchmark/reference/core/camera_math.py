"""Camera geometry: rotations, ray lifting, projections, epipolar segments,
fundamental matrices, 2-D point distances.

Counterpart of ``ssrlcv_tpu/core/camera_math.py``; the same conventions:
``rotation_matrix(angles)`` builds R = Rz(z) @ Ry(y) @ Rx(x), a camera's
``cam_rot`` rotates camera-frame vectors into the world frame, and the
world->camera projection uses R^T.  All functions are batched and
``torch.func``-safe (no in-place updates).
"""

from __future__ import annotations

import torch

from benchmark.reference.config import EARTH_MAX_KM_FROM_CENT, EARTH_MIN_KM_FROM_CENT


def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) XYZ Euler angles -> (..., 3, 3), R = Rz @ Ry @ Rx."""
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) @ (..., j) -> (..., i), broadcasting the batch axes."""
    return (m * v.unsqueeze(-2)).sum(-1)


def rotate_point(point: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Apply the XYZ-Euler rotation R(angles) @ point (broadcasts)."""
    return _matvec(rotation_matrix(angles), point)


def axis_rotations(R: torch.Tensor) -> torch.Tensor:
    """XYZ Euler angles of rotation matrices (..., 3, 3) -> (..., 3)."""
    x = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.atan2(-R[..., 2, 0], R[..., 2, 2] / torch.cos(x))
    z = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


def rotate_point_arbitrary(point: torch.Tensor, axis: torch.Tensor,
                           angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of points (..., 3) by ``angle`` about ``axis``."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    c, s = torch.cos(angle), torch.sin(angle)
    k = 1.0 - c
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    R = torch.stack(
        [
            torch.stack([ax * ax * k + c, ax * ay * k - az * s, ax * az * k + ay * s], -1),
            torch.stack([ax * ay * k + az * s, ay * ay * k + c, ay * az * k - ax * s], -1),
            torch.stack([ax * az * k - ay * s, ay * az * k + ax * s, az * az * k + c], -1),
        ],
        dim=-2,
    )
    return _matvec(R, point)


def effective_dpix(foc: torch.Tensor, fov_x: torch.Tensor, size_x: torch.Tensor) -> torch.Tensor:
    """dpix recomputed from foc/fov as the bundle generator does (square
    pixels assumed)."""
    return (foc * torch.tan(fov_x / 2.0)) / (size_x.to(torch.float32) / 2.0)


def pixel_to_ray(loc, cam_pos, cam_rot, foc, fov_x, size):
    """Lift pixel locations (..., 2) to world-frame unit rays: image plane at
    z=foc, pixel scaled by dpix about the image centre, rotated by cam_rot,
    origin cam_pos.  Returns (vec, pnt), each (..., 3)."""
    d = effective_dpix(foc, fov_x, size[..., 0])
    kp = torch.stack(
        [
            d * (loc[..., 0] - size[..., 0].to(torch.float32) / 2.0),
            d * (loc[..., 1] - size[..., 1].to(torch.float32) / 2.0),
            torch.broadcast_to(foc, loc[..., 0].shape),
        ],
        dim=-1,
    )
    vec = rotate_point(kp, cam_rot)
    vec = vec / torch.linalg.norm(vec, dim=-1, keepdim=True)
    pnt = torch.broadcast_to(cam_pos, vec.shape)
    return vec, pnt


def projection_matrix(cam_pos, cam_rot, foc, dpix, size, ecef_offset) -> torch.Tensor:
    """3x4 world->pixel projection P = K [R^T | -R^T c]; (..., 3, 4)."""
    fx = foc / dpix[..., 0]
    fy = foc / dpix[..., 1]
    cx = size[..., 0].to(torch.float32) / 2.0
    cy = size[..., 1].to(torch.float32) / 2.0
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    K = torch.stack(
        [
            torch.stack([fx, zero, cx], -1),
            torch.stack([zero, fy, cy], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=-2,
    )
    Rt = rotation_matrix(cam_rot).transpose(-1, -2)
    cent = cam_pos + ecef_offset
    t = -_matvec(Rt, cent)
    Rt4 = torch.cat([Rt, t[..., None]], dim=-1)
    return (K.unsqueeze(-1) * Rt4.unsqueeze(-3)).sum(-2)


def epipolar_segment_endpoints(loc, q_cam_pos, q_cam_rot, q_foc, q_dpix, q_size,
                               q_ecef_offset, target_P, delta: float):
    """Project the Earth-bounded segment of each query pixel's back-projected
    ray into the target image.  loc: (..., 2); returns (p1, p2), each
    (..., 2): the target-image endpoints at the max/min plausible Earth
    radius +- delta."""
    qvec = torch.stack(
        [
            q_dpix[..., 0] * (loc[..., 0] - q_size[..., 0].to(torch.float32) / 2.0),
            q_dpix[..., 1] * (loc[..., 1] - q_size[..., 1].to(torch.float32) / 2.0),
            torch.broadcast_to(q_foc, loc[..., 0].shape),
        ],
        dim=-1,
    )
    qvec = rotate_point(qvec, q_cam_rot)
    qcent = q_cam_pos + q_ecef_offset

    a = torch.sum(qvec * qvec, dim=-1)
    b = 2.0 * torch.sum(qvec * qcent, dim=-1)
    cc = torch.sum(qcent * qcent, dim=-1)
    c1 = cc - (EARTH_MAX_KM_FROM_CENT + delta) ** 2
    c2 = cc - (EARTH_MIN_KM_FROM_CENT - delta) ** 2

    def _hit(cq):
        disc = torch.clamp(b * b - 4.0 * a * cq, min=0.0)
        t = (-torch.sqrt(disc) - b) / (2.0 * a)
        return t[..., None] * qvec + qcent

    def _proj(X):
        Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
        x = _matvec(target_P, Xh)
        return x[..., :2] / x[..., 2:3]

    return _proj(_hit(c1)), _proj(_hit(c2))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ u = v x u; (..., 3) -> (..., 3, 3)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], zero, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], zero], -1),
        ],
        dim=-2,
    )


def fundamental_from_cameras(cam_rot0, cam_pos0, cam_rot1, cam_pos1, foc_pixels, size):
    """Fundamental matrix of two Euler-parameterised cameras sharing
    intrinsics (focal length in pixels, principal point at the image
    centre): F = K^-T [t]_x R K^-1, with R, t the motion from camera-0 to
    camera-1 coordinates.  Used by the F-matrix constrained matcher."""
    cx = size[..., 0].to(torch.float32) / 2.0
    cy = size[..., 1].to(torch.float32) / 2.0
    zero = torch.zeros_like(foc_pixels)
    one = torch.ones_like(foc_pixels)
    K = torch.stack(
        [
            torch.stack([foc_pixels, zero, cx], -1),
            torch.stack([zero, foc_pixels, cy], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=-2,
    )
    R0 = rotation_matrix(cam_rot0)
    R1t = rotation_matrix(cam_rot1).transpose(-1, -2)
    R_rel = R1t @ R0
    t_rel = _matvec(R1t, cam_pos0 - cam_pos1)
    E = skew(t_rel) @ R_rel
    K_inv = torch.linalg.inv(K)
    return K_inv.transpose(-1, -2) @ E @ K_inv


def point_line_distance_2d(pts: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
    """Distance of 2-D points (..., 2) to homogeneous lines (..., 3)."""
    num = torch.abs(lines[..., 0] * pts[..., 0] + lines[..., 1] * pts[..., 1] + lines[..., 2])
    den = torch.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def point_segment_distance_2d(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of points p (..., 2) to the 2-D segments [a, b] (..., 2)."""
    ab = b - a
    ap = p - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-20)
    t = torch.clamp(torch.sum(ap * ab, dim=-1) / denom, 0.0, 1.0)
    return torch.linalg.norm(p - (a + t[..., None] * ab), dim=-1)
