"""A seeded synthetic 2-view scene at orbital scale: a test and smoke-run
fixture, not a pipeline feature.

The scene is a sphere of radius 6371 km (inside the Earth-radius band the
double-constrained matcher searches, ``ssrlcv_tpu.config``) carrying a
multi-octave value-noise albedo defined on ground coordinates, so every view
sees the same surface.  Two pinhole cameras about 400 km above the ground and
about 70 km apart both aim at one ground point; a third camera aims at a
ground point about 200 km away and gives the seed image.  Optics follow the
JAX package's pose-test rig: focal length 0.8593 and a field of view of
0.0418879 rad at 1024 px (the field of view scales with ``size``, so the
ground sample distance, about 16 m, is the same at every size).

Each pixel's ray is intersected with the sphere in float64 and samples the
texture with 2x2 supersampling; the mean is quantised to uint8.  Everything
is numpy, made from ``numpy.random.default_rng(seed)`` and an integer hash
of the seed; nothing depends on global random state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ssrlcv_tpu.io.refdata import RefImage

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


@dataclasses.dataclass
class SyntheticScene:
    images: list          # [RefImage, RefImage]: the 2-view pair (ids 0, 1)
    seed_image: RefImage  # id -1
    radius_km: float

    def ground_points(self, loc0: np.ndarray) -> np.ndarray:
        """True surface points (n, 3), km relative to image 0's ECEF offset,
        seen by image 0 at pixel locations ``loc0`` (n, 2)."""
        im = self.images[0]
        org = np.asarray(im.ecef_offset, np.float64) + np.asarray(im.cam_pos, np.float64)
        d = _rays(np.asarray(loc0, np.float64), im)
        return _hit_sphere(org, d, self.radius_km) - np.asarray(im.ecef_offset, np.float64)

    def surface_distance_m(self, points: np.ndarray) -> np.ndarray:
        """Distance (m) of points (n, 3), km relative to image 0's ECEF
        offset, from the true surface (the sphere)."""
        p = np.asarray(points, np.float64) + np.asarray(self.images[0].ecef_offset, np.float64)
        return np.abs(np.linalg.norm(p, axis=1) - self.radius_km) * 1000.0


def _rotation_matrix(a) -> np.ndarray:
    """R = Rz @ Ry @ Rx of XYZ Euler angles (as ssrlcv_tpu.core.camera_math)."""
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
    unit vector ``axis``: R[:, 2] = (sin y cos x, -sin x, cos y cos x)."""
    x = np.arcsin(-axis[1])
    y = np.arctan2(axis[0], axis[2])
    return np.array([x, y, 0.0])


def _rays(loc: np.ndarray, im: RefImage) -> np.ndarray:
    """Unit world directions of pixel locations (n, 2) for camera ``im``
    (the model of camera_math.pixel_to_ray, in float64)."""
    w, h = im.size
    d = FOC * np.tan(float(im.fov[0]) / 2.0) / (w / 2.0)
    kp = np.stack([d * (loc[:, 0] - w / 2.0), d * (loc[:, 1] - h / 2.0),
                   np.full(len(loc), FOC)], axis=1)
    v = kp @ _rotation_matrix(np.asarray(im.cam_rot, np.float64)).T
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _hit_sphere(org: np.ndarray, d: np.ndarray, radius: float) -> np.ndarray:
    """Near intersection of rays org + t d (unit d) with the sphere."""
    b = d @ org
    c = org @ org - radius * radius
    t = -b - np.sqrt(np.maximum(b * b - c, 0.0))
    return org[None, :] + t[:, None] * d


def _hash01(ix: np.ndarray, iy: np.ndarray, salt: int) -> np.ndarray:
    """Uniform [0, 1) values of integer lattice points: a splitmix64-style
    hash of (ix, iy, salt)."""
    with np.errstate(over="ignore"):
        h = (ix.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             ^ iy.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
             ^ np.uint64(salt) * np.uint64(0x165667B19E3779F9))
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = h ^ (h >> np.uint64(31))
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _texture(u: np.ndarray, v: np.ndarray, salt: int) -> np.ndarray:
    """Multi-octave value noise at ground coordinates (u, v) in km."""
    out = np.zeros_like(u)
    amp = 1.0
    for k in range(_NOISE_OCTAVES):
        step = _NOISE_L0_KM / (2 ** k)
        x, y = u / step, v / step
        ix, iy = np.floor(x), np.floor(y)
        fx, fy = x - ix, y - iy
        sx, sy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
        ix, iy = ix.astype(np.int64), iy.astype(np.int64)
        s = salt * 64 + k
        v00, v10 = _hash01(ix, iy, s), _hash01(ix + 1, iy, s)
        v01, v11 = _hash01(ix, iy + 1, s), _hash01(ix + 1, iy + 1, s)
        top = v00 + sx * (v10 - v00)
        bot = v01 + sx * (v11 - v01)
        out += amp * (top + sy * (bot - top))
        amp *= _NOISE_GAIN
    return out


def _tangent_frame(up: np.ndarray):
    e1 = np.cross([0.0, 0.0, 1.0], up)
    e1 /= np.linalg.norm(e1)
    return e1, np.cross(up, e1)


def _render(im: RefImage, salt: int, origin: np.ndarray, e1, e2) -> np.ndarray:
    """Float (H, W) texture of the sphere seen by camera ``im`` (whose ECEF
    position is ecef_offset + cam_pos), 2x2 supersampled."""
    w, h = im.size
    org = np.asarray(im.ecef_offset, np.float64) + np.asarray(im.cam_pos, np.float64)
    acc = np.zeros((h, w))
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    for oy in (-0.25, 0.25):
        for ox in (-0.25, 0.25):
            loc = np.stack([xs.ravel() + ox, ys.ravel() + oy], axis=1)
            g = _hit_sphere(org, _rays(loc, im), RADIUS_KM) - origin
            acc += _texture(g @ e1, g @ e2, salt).reshape(h, w)
    return acc / 4.0


def _camera(target: np.ndarray, along: np.ndarray, offset_km: float, size: int,
            image_id: int, ecef_offset: np.ndarray) -> RefImage:
    """A camera ALTITUDE_KM above the ground point offset_km from ``target``
    along the tangent ``along``, aimed at ``target``."""
    up = target / np.linalg.norm(target)
    ground = up * RADIUS_KM + along * offset_km
    pos = ground / np.linalg.norm(ground) * (RADIUS_KM + ALTITUDE_KM)
    axis = (target - pos) / np.linalg.norm(target - pos)
    fov = np.float32(FOV_AT_1024 * size / 1024.0)
    dpix = np.float32(np.float32(FOC) * np.tan(fov / np.float32(2.0)) / np.float32(size / 2.0))
    return RefImage(
        id=image_id, size=(size, size), color_depth=1,
        cam_pos=(pos - ecef_offset).astype(np.float32),
        cam_rot=_aim(axis).astype(np.float32),
        fov=np.array([fov, fov], np.float32), foc=float(np.float32(FOC)),
        dpix=np.array([dpix, dpix], np.float32), timestamp=0,
        ecef_offset=ecef_offset.astype(np.float32), is_pushbroom=False)


def make_scene(seed: int = 0, size: int = 1024) -> SyntheticScene:
    """The 2-view pair, the seed image and the scene's truth, from ``seed``."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-0.6, 0.6)
    lon = rng.uniform(-np.pi, np.pi)
    up = np.array([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)])
    target = up * RADIUS_KM
    e1, e2 = _tangent_frame(up)
    heading = rng.uniform(0.0, 2.0 * np.pi)
    along = np.cos(heading) * e1 + np.sin(heading) * e2
    salt = int(rng.integers(1, 2 ** 31))

    # camera 0's ECEF position is the offset every camera is stored against
    cam0 = _camera(target, along, -BASELINE_KM / 2.0, size, 0, np.zeros(3))
    offset = cam0.cam_pos.astype(np.float64)
    images = [
        _camera(target, along, -BASELINE_KM / 2.0, size, 0, offset),
        _camera(target, along, BASELINE_KM / 2.0, size, 1, offset),
    ]
    side = np.cross(up, along)
    seed_target = up * RADIUS_KM + side * SEED_OFFSET_KM
    seed_target = seed_target / np.linalg.norm(seed_target) * RADIUS_KM
    seed_im = _camera(seed_target, along, 0.0, size, -1, offset)
    renders = [_render(im, salt, target, e1, e2) for im in images + [seed_im]]
    # one intensity mapping for every view (from image 0), so the views
    # differ only by geometry
    lo, hi = np.percentile(renders[0], [0.5, 99.5])
    for im, r in zip(images + [seed_im], renders):
        im.pixels = np.clip(np.round((r - lo) / (hi - lo) * 255.0), 0, 255).astype(np.uint8)
    return SyntheticScene(images=images, seed_image=seed_im, radius_km=RADIUS_KM)
