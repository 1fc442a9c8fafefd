"""The benchmark's seeded orbital scenes, rendered on the device.

A copy of ``ssrlcv_tpu_torch/synthetic.py::make_scene`` (the scene the
port's smoke runs and `bench/` scripts use) whose per-pixel work runs as float64
torch on the given device instead of numpy on the host: a sphere of radius
6371 km under a multi-octave value-noise albedo, two pinhole cameras 400 km
up and 70 km apart aimed at one ground point (a third halfway between them
for three views), and a seed camera aimed 200 km aside.  Optics are the
pose-test rig's: focal length 0.8593, a field of view of 0.0418879 rad at
1024 px (about 16 m a pixel at every size).

The cameras are a handful of numbers and are placed on the host exactly as
the original places them; each view is 2x2 supersampled, quantised to
uint8 through one intensity mapping taken from view 0.  The truth of a
scene is its sphere: ``surface_distance_m``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

RADIUS_KM = 6371.0
ALTITUDE_KM = 400.0
BASELINE_KM = 70.0
SEED_OFFSET_KM = 200.0
FOC = 0.8593
FOV_AT_1024 = 0.0418879
# value-noise octaves: coarsest lattice spacing (km), count, amplitude gain
_NOISE_L0_KM = 2.0
_NOISE_OCTAVES = 7
_NOISE_GAIN = 0.7
# splitmix64 constants as the int64 values of their bits
_U64 = 1 << 64
_C1 = 0x9E3779B97F4A7C15 - _U64
_C2 = 0xC2B2AE3D27D4EB4F - _U64
_C3 = 0x165667B19E3779F9
_M1 = 0xBF58476D1CE4E5B9 - _U64
_M2 = 0x94D049BB133111EB - _U64


@dataclasses.dataclass
class View:
    """One image with its pinhole camera (the fields of the program's
    ``RefImage``); ``pixels`` is (H, W) uint8 on the host."""

    id: int
    size: tuple
    color_depth: int
    cam_pos: np.ndarray
    cam_rot: np.ndarray
    fov: np.ndarray
    foc: float
    dpix: np.ndarray
    timestamp: int
    ecef_offset: np.ndarray
    is_pushbroom: bool
    pixels: Optional[np.ndarray] = None
    pushbroom: Optional[dict] = None


@dataclasses.dataclass
class Scene:
    views: list       # [View], ids 0 .. n-1
    seed: View        # id -1

    def surface_distance_m(self, points: torch.Tensor) -> torch.Tensor:
        """Distance (m) of points (n, 3), km relative to view 0's ECEF
        offset, from the true surface (the sphere)."""
        off = torch.as_tensor(np.asarray(self.views[0].ecef_offset, np.float64),
                              device=points.device)
        return torch.abs(torch.linalg.vector_norm(points.double() + off, dim=1)
                         - RADIUS_KM) * 1000.0


def _rotation_matrix(a) -> np.ndarray:
    """R = Rz @ Ry @ Rx of XYZ Euler angles."""
    cx, sx = np.cos(a[0]), np.sin(a[0])
    cy, sy = np.cos(a[1]), np.sin(a[1])
    cz, sz = np.cos(a[2]), np.sin(a[2])
    return np.array([
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ])


def _aim(axis: np.ndarray) -> np.ndarray:
    """Euler angles (z = 0) whose rotation maps the camera +z axis onto the
    unit vector ``axis``."""
    x = np.arcsin(-axis[1])
    y = np.arctan2(axis[0], axis[2])
    return np.array([x, y, 0.0])


def _tangent_frame(up: np.ndarray):
    e1 = np.cross([0.0, 0.0, 1.0], up)
    e1 /= np.linalg.norm(e1)
    return e1, np.cross(up, e1)


def _camera(target: np.ndarray, along: np.ndarray, offset_km: float, size: int,
            image_id: int, ecef_offset: np.ndarray) -> View:
    """A camera ALTITUDE_KM above the ground point offset_km from ``target``
    along the tangent ``along``, aimed at ``target``."""
    up = target / np.linalg.norm(target)
    ground = up * RADIUS_KM + along * offset_km
    pos = ground / np.linalg.norm(ground) * (RADIUS_KM + ALTITUDE_KM)
    axis = (target - pos) / np.linalg.norm(target - pos)
    fov = np.float32(FOV_AT_1024 * size / 1024.0)
    dpix = np.float32(np.float32(FOC) * np.tan(fov / np.float32(2.0)) / np.float32(size / 2.0))
    return View(
        id=image_id, size=(size, size), color_depth=1,
        cam_pos=(pos - ecef_offset).astype(np.float32),
        cam_rot=_aim(axis).astype(np.float32),
        fov=np.array([fov, fov], np.float32), foc=float(np.float32(FOC)),
        dpix=np.array([dpix, dpix], np.float32), timestamp=0,
        ecef_offset=ecef_offset.astype(np.float32), is_pushbroom=False)


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _rays(loc: torch.Tensor, v: View) -> torch.Tensor:
    """Unit world directions (n, 3) of pixel locations (n, 2)."""
    w, h = v.size
    d = FOC * np.tan(float(v.fov[0]) / 2.0) / (w / 2.0)
    kp = torch.stack([d * (loc[:, 0] - w / 2.0), d * (loc[:, 1] - h / 2.0),
                      torch.full_like(loc[:, 0], FOC)], dim=1)
    r = kp @ _t(_rotation_matrix(np.asarray(v.cam_rot, np.float64)).T, loc.device)
    return r / torch.linalg.vector_norm(r, dim=1, keepdim=True)


def _hit_sphere(org: torch.Tensor, d: torch.Tensor, radius: float) -> torch.Tensor:
    """Near intersection of rays org + t d (unit d) with the sphere."""
    b = d @ org
    c = org @ org - radius * radius
    t = -b - torch.sqrt(torch.clamp(b * b - c, min=0.0))
    return org[None, :] + t[:, None] * d


def _shr(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def _hash01(ix: torch.Tensor, iy: torch.Tensor, salt: int) -> torch.Tensor:
    """Uniform [0, 1) values of integer lattice points: the splitmix64-style
    hash of the original in wrapping int64 arithmetic."""
    s = (salt * _C3) % _U64
    h = (ix * _C1) ^ (iy * _C2) ^ (s - _U64 if s >= 1 << 63 else s)
    h = (h ^ _shr(h, 30)) * _M1
    h = (h ^ _shr(h, 27)) * _M2
    h = h ^ _shr(h, 31)
    return _shr(h, 11).to(torch.float64) / float(1 << 53)


def _texture(u: torch.Tensor, v: torch.Tensor, salt: int) -> torch.Tensor:
    """Multi-octave value noise at ground coordinates (u, v) in km."""
    out = torch.zeros_like(u)
    amp = 1.0
    for k in range(_NOISE_OCTAVES):
        step = _NOISE_L0_KM / (2 ** k)
        x, y = u / step, v / step
        fx0, fy0 = torch.floor(x), torch.floor(y)
        fx, fy = x - fx0, y - fy0
        sx, sy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
        ix, iy = fx0.to(torch.int64), fy0.to(torch.int64)
        s = salt * 64 + k
        v00, v10 = _hash01(ix, iy, s), _hash01(ix + 1, iy, s)
        v01, v11 = _hash01(ix, iy + 1, s), _hash01(ix + 1, iy + 1, s)
        top = v00 + sx * (v10 - v00)
        bot = v01 + sx * (v11 - v01)
        out += amp * (top + sy * (bot - top))
        amp *= _NOISE_GAIN
    return out


def _render(v: View, salt: int, origin, e1, e2, device) -> torch.Tensor:
    """Float64 (H, W) texture of the sphere seen by camera ``v``, 2x2
    supersampled."""
    w, h = v.size
    org = _t(np.asarray(v.ecef_offset, np.float64) + np.asarray(v.cam_pos, np.float64), device)
    origin, e1, e2 = _t(origin, device), _t(e1, device), _t(e2, device)
    acc = torch.zeros((h, w), dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    for oy in (-0.25, 0.25):
        for ox in (-0.25, 0.25):
            loc = torch.stack([xs.reshape(-1) + ox, ys.reshape(-1) + oy], dim=1)
            g = _hit_sphere(org, _rays(loc, v), RADIUS_KM) - origin
            acc += _texture(g @ e1, g @ e2, salt).reshape(h, w)
    return acc / 4.0


def make_scene(seed: int, size: int, n_views: int, device) -> Scene:
    """The views and the seed image of scene ``seed`` (any integer), with
    their pixels rendered on ``device`` and returned to the host."""
    if n_views not in (2, 3):
        raise ValueError(f"make_scene: n_views must be 2 or 3, got {n_views}")
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-0.6, 0.6)
    lon = rng.uniform(-np.pi, np.pi)
    up = np.array([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)])
    target = up * RADIUS_KM
    e1, e2 = _tangent_frame(up)
    heading = rng.uniform(0.0, 2.0 * np.pi)
    along = np.cos(heading) * e1 + np.sin(heading) * e2
    salt = int(rng.integers(1, 2 ** 31))

    cam0 = _camera(target, along, -BASELINE_KM / 2.0, size, 0, np.zeros(3))
    offset = cam0.cam_pos.astype(np.float64)
    views = [_camera(target, along, -BASELINE_KM / 2.0, size, 0, offset),
             _camera(target, along, BASELINE_KM / 2.0, size, 1, offset)]
    if n_views == 3:
        views.append(_camera(target, along, 0.0, size, 2, offset))
    side = np.cross(up, along)
    seed_target = up * RADIUS_KM + side * SEED_OFFSET_KM
    seed_target = seed_target / np.linalg.norm(seed_target) * RADIUS_KM
    seed_view = _camera(seed_target, along, 0.0, size, -1, offset)
    renders = [_render(v, salt, target, e1, e2, device) for v in views + [seed_view]]
    # one intensity mapping for every view (from view 0)
    lo, hi = torch.quantile(renders[0].reshape(-1),
                            torch.tensor([0.005, 0.995], dtype=torch.float64, device=device))
    for v, r in zip(views + [seed_view], renders):
        v.pixels = torch.clamp(torch.round((r - lo) / (hi - lo) * 255.0), 0, 255).to(
            torch.uint8).cpu().numpy()
    return Scene(views=views, seed=seed_view)
