"""Morton-code point-cloud octree.

Counterpart of ``ssrlcv_tpu/mesh/octree.py``: points are normalised into
their bounding box, given interleaved-bit Morton keys at a target depth,
and sorted (stably; invalid points last); neighbourhood queries take the
k nearest of a +-window in Morton order by true distance, or of every
point (``knn_exact``).

The keys are int64 with the JAX package's uint32 values (30 bits; 0xFFFFFFFF
for an invalid point).  Neighbours with tied distances keep the lower
candidate column first (a stable sort), as ``lax.top_k`` does.  Sums over
neighbours and coordinates run left to right in separately rounded steps,
long sums and square roots run in float64 and are rounded once, and
eigenvectors are solved in float64 and rounded once, so the card and the
CPU agree on keys, neighbours, distances and masks bit for bit and on
normals to float32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ssrlcv_tpu_torch.core.device import as_device_tensor

INVALID_KEY = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over a last axis of 3, as (a0 b0 + a1 b1) + a2 b2."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt correctly rounded on every device (float64, rounded once): the
    card's float32 sqrt is not."""
    return torch.sqrt(x.double()).to(x.dtype)


def _norm3(a: torch.Tensor) -> torch.Tensor:
    return _sqrt(_dot3(a, a))


def _sum_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` left to right, one rounded addition at a time."""
    acc = x.select(dim, 0)
    for j in range(1, x.shape[dim]):
        acc = acc + x.select(dim, j)
    return acc


def _sum64(x: torch.Tensor, dim=None) -> torch.Tensor:
    """A long sum accumulated in float64 and rounded once to x's dtype, so
    devices that add in different orders agree."""
    s = torch.sum(x.double()) if dim is None else torch.sum(x.double(), dim=dim)
    return s.to(x.dtype)


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d for a Python number d, correctly rounded on every device (CUDA
    turns division by a Python number into a product by its reciprocal)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def morton_keys(points: torch.Tensor, bbox_min: torch.Tensor, bbox_max: torch.Tensor,
                depth: int) -> torch.Tensor:
    """30-bit Morton keys (int64) at the given depth (10 bits/axis max)."""
    extent = torch.clamp(bbox_max - bbox_min, min=1e-12)
    scale = torch.full_like(extent, float(2 ** depth)) / extent
    g = ((points - bbox_min) * scale).to(torch.int64)
    g = torch.clamp(g, 0, 2 ** depth - 1)
    return _expand_bits(g[:, 0]) | (_expand_bits(g[:, 1]) << 1) | (_expand_bits(g[:, 2]) << 2)


class Octree(NamedTuple):
    """Sorted-point octree: points reordered by Morton key."""

    points: torch.Tensor    # (N, 3) sorted by key
    keys: torch.Tensor      # (N,) int64 Morton keys (sorted)
    order: torch.Tensor     # (N,) int32 original indices of the sorted points
    mask: torch.Tensor      # (N,) validity of each sorted slot
    bbox_min: torch.Tensor  # (3,)
    bbox_max: torch.Tensor  # (3,)
    depth: int


def build_octree(points, mask, depth: int = 8, device=None) -> Octree:
    """Build the sorted Morton structure on ``device`` (None: the device of
    a tensor ``points``, else ``cuda:0``).  Invalid points sort to the end
    (key 0xFFFFFFFF)."""
    points = as_device_tensor(points, device).to(torch.float32)
    mask = as_device_tensor(mask, points.device).to(torch.bool)
    m = mask[:, None]
    bbox_min = torch.amin(torch.where(m, points, torch.inf), dim=0)
    bbox_max = torch.amax(torch.where(m, points, -torch.inf), dim=0)
    keys = morton_keys(points, bbox_min, bbox_max, depth)
    keys = torch.where(mask, keys, INVALID_KEY)
    keys, order = torch.sort(keys, stable=True)
    return Octree(points=points[order], keys=keys, order=order.to(torch.int32), mask=mask[order],
                  bbox_min=bbox_min, bbox_max=bbox_max, depth=depth)


def _smallest_k(d: torch.Tensor, k: int):
    """The k smallest of each row, ascending, ties in column order."""
    d, col = torch.sort(d, dim=1, stable=True)
    return d[:, :k], col[:, :k]


def knn(tree: Octree, k: int = 8, window: int = 32):
    """Approximate k nearest neighbours per point from a +-window in Morton
    order, by true distance.  Returns (neighbor_idx (N, k) int32 into the
    *sorted* order, neighbor_dist (N, k)); inf where fewer are valid."""
    n = tree.points.shape[0]
    dev = tree.points.device
    offs = torch.arange(-window, window + 1, device=dev)
    raw = torch.arange(n, device=dev)[:, None] + offs[None, :]
    in_range = (raw >= 0) & (raw < n)
    idx = torch.clamp(raw, 0, n - 1)
    d = _norm3(tree.points[idx] - tree.points[:, None, :])
    valid = in_range & tree.mask[idx] & tree.mask[:, None] & (offs[None, :] != 0)
    d, col = _smallest_k(torch.where(valid, d, torch.inf), k)
    return torch.gather(idx, 1, col).to(torch.int32), d


def knn_exact(points: torch.Tensor, mask: torch.Tensor, k: int = 8,
              max_elements: int = 1 << 24):
    """Exact brute-force kNN over every valid point (row chunks of at most
    ``max_elements`` distances); a zero distance (the point itself, or a
    duplicate) is excluded, as in the JAX package."""
    n = points.shape[0]
    rows = max(1, max_elements // max(n, 1))
    out_idx, out_d = [], []
    for s0 in range(0, n, rows):
        d = _norm3(points[s0:s0 + rows, None, :] - points[None, :, :])
        d = torch.where(mask[None, :], d, torch.inf)
        d = torch.where(d == 0.0, torch.inf, d)
        d, col = _smallest_k(d, k)
        out_idx.append(col.to(torch.int32))
        out_d.append(d)
    return torch.cat(out_idx), torch.cat(out_d)


def average_neighbor_distances(tree: Octree, k: int = 8, window: int = 32) -> torch.Tensor:
    """Mean distance to the (windowed) k nearest neighbours per point."""
    _, d = knn(tree, k=k, window=window)
    finite = torch.isfinite(d)
    total = _sum_rows(torch.where(finite, d, 0.0), 1)
    return total / torch.clamp(finite.sum(1), min=1).to(d.dtype)


def _eigh_smallest(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of each symmetric 3x3's smallest eigenvalue, solved
    in float64 and rounded once.  A non-finite matrix (a neighbourhood
    holding a non-finite point) gives NaN, as jnp.linalg.eigh does, where
    torch's solver would raise."""
    ok = torch.isfinite(cov).flatten(1).all(1)
    eye = torch.eye(3, dtype=torch.float64, device=cov.device)
    safe = torch.where(ok[:, None, None], cov.double(), eye)
    vec = torch.linalg.eigh(safe)[1][:, :, 0].to(cov.dtype)
    return torch.where(ok[:, None], vec, torch.nan)


def compute_normals(tree: Octree, camera_positions, k: int = 8, window: int = 32) -> torch.Tensor:
    """Per-point normals (sorted order) from the neighbourhood covariance's
    smallest-eigenvalue vector, turned toward the mean camera position.
    Returns (N, 3) unit normals."""
    nbr_idx, _ = knn(tree, k=k, window=window)
    nbrs = tree.points[nbr_idx.long()]                           # (N, k, 3)
    mean = _div(_sum_rows(nbrs, 1), k)
    centered = nbrs - mean[:, None, :]
    cov = _sum_rows(centered[:, :, :, None] * centered[:, :, None, :], 1)
    normals = _eigh_smallest(cov)
    cams = as_device_tensor(camera_positions, tree.points.device).to(torch.float32)
    cam_mean = _div(_sum_rows(cams, 0), cams.shape[0])
    flip = _dot3(normals, cam_mean[None, :] - tree.points) < 0
    normals = torch.where(flip[:, None], -normals, normals)
    return normals / torch.clamp(_norm3(normals), min=1e-12)[:, None]


def remove_low_density_points(tree: Octree, sigma: float = 3.0, k: int = 8,
                              window: int = 32) -> Octree:
    """Mask points whose mean neighbour distance exceeds the population
    mean by more than sigma standard deviations."""
    avg = average_neighbor_distances(tree, k=k, window=window)
    m = tree.mask
    cnt = torch.clamp(m.sum(), min=1).to(avg.dtype)
    mu = _sum64(torch.where(m, avg, 0.0)) / cnt
    var = _sum64(torch.where(m, (avg - mu) ** 2, 0.0)) / cnt
    return tree._replace(mask=m & (avg <= mu + sigma * _sqrt(var)))


def node_counts(tree: Octree, depth: int) -> int:
    """Number of unique occupied nodes at a coarser depth."""
    shift = 3 * (tree.depth - depth)
    keys = tree.keys[tree.mask].cpu().numpy()
    return int(np.unique(keys >> shift).size)


_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)
# 12 cube edges as corner-index pairs
_CUBE_EDGES = np.array(
    [[0, 1], [2, 3], [4, 5], [6, 7],
     [0, 2], [1, 3], [4, 6], [5, 7],
     [0, 4], [1, 5], [2, 6], [3, 7]], np.int64)


def octree_wireframe(tree: Octree, level: int | None = None):
    """Host-side: unique occupied node cubes at `level` as deduplicated
    corner vertices + 12 edges per node.  Returns (vertices (V, 3) f32,
    edges (E, 2) i64)."""
    level = tree.depth if level is None else level
    m = tree.mask.cpu().numpy()
    pts = tree.points.cpu().numpy()[m]
    bmin = tree.bbox_min.cpu().numpy()
    bmax = tree.bbox_max.cpu().numpy()
    n_cells = 2 ** level
    cell = np.maximum(bmax - bmin, 1e-12) / n_cells
    grid = np.clip(((pts - bmin) / cell).astype(np.int64), 0, n_cells - 1)
    nodes = np.unique(grid, axis=0)                       # (M, 3) occupied cells
    corners = nodes[:, None, :] + _CUBE_CORNERS[None]     # (M, 8, 3) lattice coords
    verts_lattice, inv = np.unique(corners.reshape(-1, 3), axis=0, return_inverse=True)
    corner_idx = inv.reshape(-1, 8)                       # (M, 8) dedup'd ids
    edges = corner_idx[:, _CUBE_EDGES].reshape(-1, 2)     # (M*12, 2)
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    vertices = (verts_lattice * cell[None, :] + bmin[None, :]).astype(np.float32)
    return vertices, edges


def write_octree_ply(path_prefix: str, tree: Octree, level: int | None = None):
    """Write <prefix>_points.ply / <prefix>_wireframe.ply."""
    from ssrlcv_tpu_torch.io.ply import write_ply, write_ply_edges

    p1 = write_ply(path_prefix + "_points.ply", tree.points[tree.mask].cpu().numpy())
    v, e = octree_wireframe(tree, level)
    p2 = write_ply_edges(path_prefix + "_wireframe.ply", v, e)
    return p1, p2
