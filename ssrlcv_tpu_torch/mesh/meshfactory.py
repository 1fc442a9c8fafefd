"""Mesh / point-cloud post-processing.

Counterpart of ``ssrlcv_tpu/mesh/meshfactory.py``: neighbour-distance
outlier filtering, the normal-based implicit surface, surface
reconstruction by isosurface extraction on a regular grid, the three
octree-lattice meshers, PLY save / load and the cloud comparison metric.

The nearest-point searches run in torch on the cloud's device in row
chunks of at most ``max_elements`` grid-point pairs (the JAX package's
``lax.map`` chunks are a TPU memory choice); their distances are written
out coordinate by coordinate, so the card and the CPU pick the same points.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ssrlcv_tpu_torch.io import ply
from ssrlcv_tpu_torch.mesh import octree as oc
from ssrlcv_tpu_torch.mesh.marching_cubes import compact_mesh, marching_tetrahedra


class Mesh:
    """Host-side mesh container: points, optional faces and colours."""

    def __init__(self, points: np.ndarray, faces: Optional[np.ndarray] = None,
                 colors: Optional[np.ndarray] = None):
        self.points = np.asarray(points, np.float32)
        self.faces = None if faces is None else np.asarray(faces, np.int32)
        self.colors = None if colors is None else np.asarray(colors, np.uint8)

    def save_points(self, path: str) -> str:
        return ply.write_ply(path, self.points, colors=self.colors)

    def save_mesh(self, path: str) -> str:
        return ply.write_ply(path, self.points, colors=self.colors, faces=self.faces)

    @classmethod
    def load(cls, path: str) -> "Mesh":
        d = ply.read_ply(path)
        return cls(d["points"], faces=d["faces"], colors=d["colors"])


def filter_by_neighbor_distance(points, mask, sigma: float = 3.0, k: int = 8, window: int = 32,
                                device=None) -> torch.Tensor:
    """Drop points whose mean kNN distance exceeds sigma standard
    deviations.  Returns the updated mask in the ORIGINAL point order."""
    tree = oc.build_octree(points, mask, device=device)
    filtered = oc.remove_low_density_points(tree, sigma=sigma, k=k, window=window)
    out = torch.zeros_like(filtered.mask)
    out[filtered.order.long()] = filtered.mask
    return out


def implicit_from_normals(grid_points: torch.Tensor, surf_points: torch.Tensor,
                          normals: torch.Tensor, mask: torch.Tensor,
                          max_elements: int = 1 << 25) -> torch.Tensor:
    """Signed distance of each grid sample to the plane of its nearest
    valid cloud point."""
    n = surf_points.shape[0]
    rows = max(1, max_elements // max(n, 1))
    out = []
    for s0 in range(0, grid_points.shape[0], rows):
        pc = grid_points[s0:s0 + rows]
        diff = [pc[:, None, i] - surf_points[None, :, i] for i in range(3)]
        d = oc._sqrt((diff[0] * diff[0] + diff[1] * diff[1]) + diff[2] * diff[2])
        nearest = torch.argmin(torch.where(mask[None, :], d, torch.inf), dim=1)
        out.append(oc._dot3(pc - surf_points[nearest], normals[nearest]))
    return torch.cat(out)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace's float32 formula: start * (1 - s) + stop * s for s =
    i / (num - 1), then stop itself."""
    div = num - 1
    step = oc._div(torch.arange(div, dtype=start.dtype, device=start.device), div)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def reconstruct_surface(points, mask, camera_positions, resolution: int = 64, k: int = 8,
                        device=None) -> Mesh:
    """Normals -> implicit field on a regular resolution^3 grid padded
    around the cloud -> isosurface triangles -> compacted mesh, on
    ``device`` (None: the device of a tensor ``points``, else ``cuda:0``)."""
    tree = oc.build_octree(points, mask, device=device)
    normals = oc.compute_normals(tree, camera_positions, k=k)

    extent = tree.bbox_max - tree.bbox_min
    # degenerate (near-planar) clouds still need volume around the surface
    pad = torch.maximum(0.05 * extent, 0.05 * torch.max(extent))
    lo = tree.bbox_min - pad
    hi = tree.bbox_max + pad
    axes = [_linspace(lo[i], hi[i], resolution) for i in range(3)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)

    vals = implicit_from_normals(grid, tree.points, normals, tree.mask)
    field = vals.reshape(resolution, resolution, resolution)
    spacing = oc._div(hi - lo, resolution - 1)
    tris, tmask = marching_tetrahedra(field, lo, spacing, isolevel=0.0)
    verts, faces = compact_mesh(tris, tmask)
    return Mesh(verts, faces=faces)


def _hier_and_normals(points, mask, camera_positions, depth: int, device=None):
    """The octree-lattice meshers' preparation: the hierarchy (host numpy)
    and per-point normals in hier.points order (a tensor on ``device``)."""
    from ssrlcv_tpu_torch.mesh.hierarchy import build_hierarchy

    if device is None and isinstance(points, torch.Tensor):
        device = points.device
    to_np = (lambda x: x.detach().cpu().numpy()) if isinstance(points, torch.Tensor) else np.asarray
    hier = build_hierarchy(to_np(points), to_np(mask), depth=depth)
    tree = oc.build_octree(hier.points, np.ones(hier.points.shape[0], bool), device=device)
    nrm_sorted = oc.compute_normals(tree, camera_positions)
    nrm = torch.empty_like(nrm_sorted)
    nrm[tree.order.long()] = nrm_sorted       # tree.order indexes hier.points
    return hier, nrm


def marching_cubes_octree(points, mask, camera_positions, depth: int = 6, device=None) -> Mesh:
    """Finest-level octree-lattice marching cubes."""
    from ssrlcv_tpu_torch.mesh.mc_octree import marching_cubes_level, vertex_implicit_from_normals

    hier, nrm = _hier_and_normals(points, mask, camera_positions, depth, device)
    verts, tris = marching_cubes_level(hier, vertex_implicit_from_normals(hier, nrm), level=0)
    return Mesh(verts, faces=tris)


def adaptive_marching_cubes(points, mask, camera_positions, depth: int = 6, device=None) -> Mesh:
    """Top-down adaptive marching cubes."""
    from ssrlcv_tpu_torch.mesh.mc_octree import adaptive_marching_cubes as _amc

    hier, nrm = _hier_and_normals(points, mask, camera_positions, depth, device)
    verts, tris = _amc(hier, nrm)
    return Mesh(verts, faces=tris)


def jax_meshing(points, mask, camera_positions, depth: int = 6, device=None) -> Mesh:
    """Surface-depth search + marching cubes: the mesher the JAX package
    calls ``jax_meshing`` (the reference's jaxMeshing, MeshFactory.cu:1015),
    here in torch -- the name is kept so a reader finds the counterpart."""
    from ssrlcv_tpu_torch.mesh.mc_octree import jax_meshing as _jm

    hier, nrm = _hier_and_normals(points, mask, camera_positions, depth, device)
    verts, tris, _level = _jm(hier, nrm)
    return Mesh(verts, faces=tris)


def generate_mesh(mesh: Mesh, out_dir: str, name: str, depth: int) -> str:
    """Write ``<out_dir>/<name>_mesh_march_<depth>.ply``."""
    return mesh.save_mesh(os.path.join(out_dir, f"{name}_mesh_march_{depth}"))


def average_cloud_difference(a, b) -> float:
    """Mean nearest-neighbour distance from cloud a to cloud b (host, scipy
    k-d tree)."""
    from scipy.spatial import cKDTree

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    d, _ = cKDTree(host(b)).query(host(a))
    return float(np.mean(d))

