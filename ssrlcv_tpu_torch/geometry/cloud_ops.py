"""Point-cloud transforms and debug / analysis writers.

Counterpart of ``ssrlcv_tpu/geometry/cloud_ops.py``: scale, translate,
rotate and the masked centroid on the cloud's device; the colour-coded
debug clouds, the error-versus-parameter sensitivity sweeps, the planar
filter's estimated plane as a quad mesh, and the bundle-adjustment noise
self-test.  The writers fetch their arrays to the host.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ssrlcv_tpu_torch.ba.lm import pack
from ssrlcv_tpu_torch.core import camera_math
from ssrlcv_tpu_torch.core.types import Bundles, Cameras, MatchSet, PointCloud
from ssrlcv_tpu_torch.io import ply


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def scale_cloud(points: torch.Tensor, scale: float) -> torch.Tensor:
    return points * scale


def translate_cloud(points: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    return points + translation


def rotate_cloud(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """XYZ-Euler rotation about the origin."""
    return camera_math.rotate_point(points, angles)


def cloud_average(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked centroid (sums in float64, rounded once, so every device
    agrees)."""
    from ssrlcv_tpu_torch.mesh.octree import _sum64

    w = mask[:, None].to(points.dtype)
    return _sum64(points * w, dim=0) / torch.clamp(_sum64(w), min=1.0)


def estimated_plane_normal(tree, normals: torch.Tensor) -> torch.Tensor:
    """The unit average of the valid points' normals (the planar filter's
    plane normal)."""
    from ssrlcv_tpu_torch.mesh.octree import _norm3, _sum64

    w = tree.mask[:, None].to(normals.dtype)
    normal = _sum64(normals * w, dim=0) / torch.clamp(_sum64(w), min=1.0)
    return normal / torch.clamp(_norm3(normal), min=1e-12)


def save_debug_cloud(path: str, cloud: PointCloud, cameras: Cameras,
                     bundles: Optional[Bundles] = None, projection_scale: float = 1.0) -> str:
    """Colour-coded debug PLY: cloud points GREEN, cameras RED, the ray
    points at ``projection_scale`` along each bundle BLUE."""
    pts = [_host(cloud.points)[_host(cloud.mask)]]
    cols = [np.tile([0, 255, 0], (len(pts[0]), 1))]
    cam = _host(cameras.cam_pos)
    pts.append(cam)
    cols.append(np.tile([255, 0, 0], (len(cam), 1)))
    if bundles is not None:
        m = _host(bundles.mask)
        proj = (_host(bundles.pnt)[m].reshape(-1, 3)
                + projection_scale * _host(bundles.vec)[m].reshape(-1, 3))
        pts.append(proj)
        cols.append(np.tile([0, 0, 255], (len(proj), 1)))
    return ply.write_ply(path, np.vstack(pts).astype(np.float32),
                         colors=np.vstack(cols).astype(np.uint8))


def save_linear_error_cloud(path: str, cloud: PointCloud) -> str:
    """Per-point error as a heat gradient."""
    m = _host(cloud.mask)
    return ply.write_ply_gradient(path, _host(cloud.points)[m], _host(cloud.errors)[m])


def save_view_number_cloud(path: str, cloud: PointCloud, matches: MatchSet) -> str:
    """Points coloured by their number of contributing views."""
    m = _host(cloud.mask)
    return ply.write_ply_gradient(path, _host(cloud.points)[m],
                                  _host(matches.num_views)[m].astype(np.float32))


def generate_sensitivity_functions(matches: MatchSet, cameras: Cameras, out_dir: str,
                                   deltas: np.ndarray = None,
                                   prefix: str = "sensitivity") -> dict[str, str]:
    """Error-versus-parameter CSV sweeps: for each of camera 1's 6
    parameters, offset it over ``deltas`` and record the total linear error
    in ``<out_dir>/<prefix>_<name>.csv``."""
    from ssrlcv_tpu_torch.ba.two_view import make_objective

    if deltas is None:
        deltas = np.linspace(-1e-3, 1e-3, 41)
    obj = make_objective(matches, cameras)
    base = pack(cameras)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for pi, name in enumerate(["pos_x", "pos_y", "pos_z", "rot_x", "rot_y", "rot_z"]):
        rows = []
        for d in deltas:
            p = base.clone()
            p[6 + pi] += float(d)  # camera 1's parameter pi
            rows.append(f"{float(d)},{float(obj(p))}\n")
        path = os.path.join(out_dir, f"{prefix}_{name}.csv")
        with open(path, "w") as f:
            f.write("offset,linear_error\n" + "".join(rows))
        out[name] = path
    return out


def visualize_plane_estimation(cloud: PointCloud, cameras: Cameras, path: str,
                               scale: float = 1000.0, k: int = 10) -> str:
    """Write the planar filter's estimated plane as an ascii quad-mesh PLY:
    the octree's camera-facing normals averaged to the plane normal, the
    cloud centroid as the plane point, a (2 * bounds / 40)^2 vertex grid
    with z from the plane equation, and quads in the order top-left,
    top-right, bottom-right, bottom-left."""
    from ssrlcv_tpu_torch.mesh import octree as oc

    tree = oc.build_octree(cloud.points, cloud.mask)
    normal = _host(estimated_plane_normal(tree, oc.compute_normals(tree, cameras.cam_pos, k=k)))
    point = _host(cloud_average(cloud.points, cloud.mask))

    step = 40
    bounds = int(scale) - (int(scale) % step)
    xs = np.arange(-bounds, bounds, step, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    nz = normal[2] if abs(normal[2]) > 1e-12 else 1e-12
    gz = point[2] - (normal[0] * (gx - point[0]) + normal[1] * (gy - point[1])) / nz
    vertices = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.float32)

    side = len(xs)
    quads = [[x * side + y, x * side + y + 1, x * side + y + side + 1, x * side + y + side]
             for x in range(side - 1) for y in range(side - 1)]
    ply.write_ply(path, vertices, faces=np.asarray(quads, np.int32), binary=False)
    return path


def test_bundle_adjustment_noise(matches: MatchSet, cameras: Cameras, generator: torch.Generator,
                                 noise_rot: float = 1e-4, noise_pos: float = 0.01,
                                 iterations: int = 10):
    """BA self-test with injected camera noise: perturb camera 1 by normal
    draws from ``generator`` (on the cameras' device), run LM bundle
    adjustment, and return (clean_error, noisy_error, recovered_error)."""
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust_two_view, make_objective

    obj = make_objective(matches, cameras)
    clean = float(obj(pack(cameras)))
    dev = cameras.cam_rot.device
    n_rot = torch.randn(3, generator=generator, device=dev)
    n_pos = torch.randn(3, generator=generator, device=dev)
    rot, pos = cameras.cam_rot.clone(), cameras.cam_pos.clone()
    rot[1] += noise_rot * n_rot
    pos[1] += noise_pos * n_pos
    noisy_cams = cameras.replace(cam_rot=rot, cam_pos=pos)
    noisy = float(obj(pack(noisy_cams)))
    r = bundle_adjust_two_view(matches, noisy_cams, iterations=iterations, mode="lm")
    return clean, noisy, float(r.final_error)
