"""Ray (bundle) generation from match tracks.

Counterpart of ``ssrlcv_tpu/geometry/bundles.py``: every (track, view) slot
is lifted to a world ray, with camera parameters gathered per slot through
the parent-id tensor.  Pinhole cameras by default; with ``pushbrooms`` the
pushbroom (scan camera) rays instead, as the JAX package dispatches.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.core import camera_math
from benchmark.reference.core.types import Bundles, Cameras, MatchSet, PushbroomCameras


def generate_bundles(matches: MatchSet, cameras: Cameras, pushbrooms=None) -> Bundles:
    """Lift each track's keypoints to world-frame rays: pixel -> image-plane
    point at z=foc (dpix from fov/foc, square pixels), rotated by cam_rot,
    origin cam_pos.  With ``pushbrooms`` (PushbroomCameras) the pushbroom
    rays instead, and ``cameras`` is not read."""
    if pushbrooms is not None:
        return generate_pushbroom_bundles(matches, pushbrooms)
    parent = torch.clamp(matches.kp_parent, min=0).to(torch.int64)
    vec, pnt = camera_math.pixel_to_ray(
        matches.kp_loc, cameras.cam_pos[parent], cameras.cam_rot[parent],
        cameras.foc[parent], cameras.fov[:, 0][parent], cameras.size[parent])
    return Bundles(vec=vec, pnt=pnt, num_views=matches.num_views, mask=matches.mask)


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) evaluated in float64 and rounded once to x's dtype: the
    correctly rounded value on any device, so the CPU and the card agree
    (the card's float32 sqrt, sin, cos and tan are not correctly rounded)."""
    return fn(x.double()).to(x.dtype)


def _rotate(p, cx, sx, cy, sy, cz, sz):
    """R @ p for R = Rz @ Ry @ Rx given the angles' cosines and sines, in
    camera_math.rotation_matrix's formula; each product rounded on its own
    and summed left to right (no fused multiply-add on any device)."""
    r = ((cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx),
         (sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx),
         (-sy, cy * sx, cy * cx))
    return [(ri[0] * p[0] + ri[1] * p[1]) + ri[2] * p[2] for ri in r]


def generate_pushbroom_bundles(matches: MatchSet, pushbrooms: PushbroomCameras) -> Bundles:
    """Pushbroom (HiRISE-style scan camera) rays: solve the orbit quadratic
    for the craft position at the scan roll, advance along the orbit by the
    row's arc length, roll the image-plane point, and emit the ray.

    The two-step ``kp = position - kp; vec = position - kp`` of the JAX
    package is kept as written: ``vec`` is the rolled image-plane point
    recovered through a craft position some thousand km from the origin,
    so in float32 it keeps only the bits that survive that round trip
    (ROADMAP.md caveat m).  The square roots, sines, cosines and tangents
    are computed in float64 and rounded once and every sum is written out,
    so the card's rays equal the CPU's bit for bit; against the JAX package
    they may differ by a few ulps."""
    parent = torch.clamp(matches.kp_parent, min=0).to(torch.int64)
    loc = matches.kp_loc                                        # (T, V, 2)
    size = pushbrooms.size[parent].to(torch.float32)            # (T, V, 2)
    dpix = pushbrooms.dpix[parent]
    foc = pushbrooms.foc[parent]
    roll_deg = pushbrooms.roll[parent]
    radius = pushbrooms.axis_radius[parent]
    altitude = pushbrooms.altitude[parent]
    gsd = pushbrooms.gsd[parent]

    center = size / 2.0
    zeros = torch.zeros_like(roll_deg)
    ones = torch.ones_like(roll_deg)
    kp = (dpix[..., 0] * (loc[..., 0] - center[..., 0]), zeros, -foc)
    roll = roll_deg * (math.pi / 180.0)
    t = _rounded(torch.tan, roll - math.pi / 2.0)
    a = 1.0 + t * t
    b = -2.0 * radius * t
    orbit = altitude + radius
    c = radius * radius - orbit * orbit
    disc = _rounded(torch.sqrt, torch.clamp(b * b - 4.0 * a * c, min=0.0))
    s1 = (-b + disc) / (2.0 * a)
    s2 = (-b - disc) / (2.0 * a)
    sol = torch.where(s1 > 0, s1, s2)
    position = (sol, zeros, -t * sol)

    arc_length = gsd * (loc[..., 1] - center[..., 1])
    angle_out = arc_length / radius

    kp = _rotate(kp, ones, zeros, _rounded(torch.cos, roll), _rounded(torch.sin, roll),
                 ones, zeros)
    position = _rotate(position, _rounded(torch.cos, angle_out), _rounded(torch.sin, angle_out),
                       ones, zeros, ones, zeros)

    kp = [p - k for p, k in zip(position, kp)]
    vec = [p - k for p, k in zip(position, kp)]
    norm = _rounded(torch.sqrt, (vec[0] * vec[0] + vec[1] * vec[1]) + vec[2] * vec[2])
    norm = torch.clamp(norm, min=1e-20)
    vec = torch.stack([v / norm for v in vec], dim=-1)
    return Bundles(vec=vec, pnt=torch.stack(position, dim=-1), num_views=matches.num_views,
                   mask=matches.mask)
