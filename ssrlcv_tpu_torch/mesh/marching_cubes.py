"""Isosurface extraction: marching cubes via tetrahedral decomposition.

Counterpart of ``ssrlcv_tpu/mesh/marching_cubes.py``: each grid cell is
split into 6 tetrahedra, and a tetrahedron crossing the isosurface emits 1
or 2 triangles chosen by its 4-bit sign pattern (16 cases), every step a
masked tensor operation on the field's device.  Output is fixed-capacity:
(cells * 12, 3, 3) vertex positions and a validity mask; ``compact_mesh``
merges vertices on the host for PLY export.  The two multiply-adds that the
JAX package's compiled kernel fuses are fused here too, so the triangles
equal its own bit for bit and merge into the same vertices.
"""

from __future__ import annotations

import numpy as np
import torch

# 6-tetrahedron decomposition of the unit cube (corner indices 0..7 with
# corner c = (x, y, z) bits = (c&1, (c>>1)&1, (c>>2)&1))
TETS = np.array(
    [
        [0, 5, 1, 3],
        [0, 5, 3, 7],
        [0, 5, 7, 4],
        [0, 7, 3, 2],
        [0, 7, 2, 6],
        [0, 7, 6, 4],
    ],
    np.int64,
)

CORNERS = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64)

# tetra edge list: 6 edges between the 4 vertices
TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)


def _edge_between(a, b):
    for e, (u, v) in enumerate(TET_EDGES):
        if (u == a and v == b) or (u == b and v == a):
            return e
    raise AssertionError


def _tet_table() -> np.ndarray:
    """For each of the 16 sign patterns (bit i set = vertex i inside), the
    up-to-2 triangles as triples of tet-edge indices (-1 = unused)."""
    table = -np.ones((16, 2, 3), np.int64)
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not (case & (1 << i))]
        if len(inside) == 1:
            a = inside[0]
            table[case, 0] = [_edge_between(a, b) for b in outside]
        elif len(inside) == 3:
            a = outside[0]
            table[case, 0] = [_edge_between(a, b) for b in inside]
        else:
            a, b = inside
            c, d = outside
            e_ac, e_ad = _edge_between(a, c), _edge_between(a, d)
            e_bc, e_bd = _edge_between(b, c), _edge_between(b, d)
            table[case, 0] = [e_ac, e_ad, e_bc]
            table[case, 1] = [e_bc, e_ad, e_bd]
    return table


TET_TRIS = _tet_table()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as the JAX package's compiled
    kernel contracts it into a fused multiply-add (the float64 product of
    two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def marching_tetrahedra(values: torch.Tensor, origin: torch.Tensor, spacing: torch.Tensor,
                        isolevel: float = 0.0):
    """Extract the isosurface of a (X, Y, Z) field sampled at origin +
    index * spacing.  Returns (tris (M, 3, 3), mask (M,)) on the field's
    device, M = cells * 12 (6 tets x 2 triangles)."""
    dev = values.device
    cx, cy, cz = (s - 1 for s in values.shape)
    ii, jj, kk = torch.meshgrid(torch.arange(cx, device=dev), torch.arange(cy, device=dev),
                                torch.arange(cz, device=dev), indexing="ij")
    cell = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3)              # (C, 3)
    corners = cell[:, None, :] + torch.as_tensor(CORNERS, device=dev)[None]   # (C, 8, 3)
    vals = values[corners[..., 0], corners[..., 1], corners[..., 2]]    # (C, 8)
    pos = _fma(corners.to(values.dtype), spacing[None, None, :], origin[None, None, :])

    tets = torch.as_tensor(TETS, device=dev)
    tet_v = vals[:, tets]                        # (C, 6, 4)
    tet_p = pos[:, tets]                         # (C, 6, 4, 3)
    inside = (tet_v > isolevel).to(torch.int64)
    case = inside[..., 0] + 2 * inside[..., 1] + 4 * inside[..., 2] + 8 * inside[..., 3]

    # interpolated crossing point on each tet edge
    e = torch.as_tensor(TET_EDGES, device=dev)
    va, vb = tet_v[..., e[:, 0]], tet_v[..., e[:, 1]]                   # (C, 6, 6)
    pa, pb = tet_p[..., e[:, 0], :], tet_p[..., e[:, 1], :]             # (C, 6, 6, 3)
    denom = vb - va
    t = torch.where(torch.abs(denom) > 1e-12, (isolevel - va) / denom, 0.5)
    t = torch.clamp(t, 0.0, 1.0)
    cross = _fma(t[..., None], pb - pa, pa)

    tri_edges = torch.as_tensor(TET_TRIS, device=dev)[case]              # (C, 6, 2, 3)
    used = tri_edges[..., 0] >= 0                                        # (C, 6, 2)
    safe = torch.clamp(tri_edges, min=0).reshape(*case.shape, 6, 1).expand(-1, -1, -1, 3)
    tris = torch.gather(cross, 2, safe)                                  # (C, 6, 6, 3)
    return tris.reshape(-1, 3, 3), used.reshape(-1)


# the reference's API name
marching_cubes = marching_tetrahedra


def compact_mesh(tris, mask, decimals: int = 6):
    """Host-side: drop masked triangles, merge vertices equal after
    rounding to ``decimals`` -> (verts (V, 3) float32, faces (F, 3) int32),
    degenerate faces dropped."""
    if isinstance(tris, torch.Tensor):
        tris, mask = tris.cpu().numpy(), mask.cpu().numpy()
    tris = np.asarray(tris)[np.asarray(mask)]
    if len(tris) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    key = np.round(tris.reshape(-1, 3), decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return uniq.astype(np.float32), faces[ok]
