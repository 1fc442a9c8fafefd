"""Octree-lattice marching cubes: plain, surface-depth (jaxMeshing), adaptive.

Counterpart of ``ssrlcv_tpu/mesh/mc_octree.py``:

  - ``vertex_implicit_from_normals`` -- per octree-lattice vertex, the
    signed cosine between the nearest cloud point's normal and the vector
    from that point to the vertex.  The nearest point is the argmin of
    ``|v|^2 + |p|^2 - 2 v.p``, as in the JAX package, computed in torch on
    the device in row chunks; its dot products are written out term by term
    (no matmul), so the card and the CPU pick the same point.  The identity
    cancels badly far from the origin (ROADMAP.md caveat n).
  - ``marching_cubes_level`` -- marching cubes over one octree level's
    node cubes, surface vertices at crossed edge midpoints.
  - ``jax_meshing`` -- the coarsest "hole-free" level, then marching cubes
    there (the JAX package's name, kept so a reader finds the counterpart).
  - ``adaptive_marching_cubes`` -- top-down refinement from the root's
    children.

Everything but the implicit values is host numpy, the JAX package's code.
"""

from __future__ import annotations

import numpy as np
import torch

from ssrlcv_tpu_torch.core.device import resolve_device
from ssrlcv_tpu_torch.mesh.hierarchy import OctreeHierarchy
from ssrlcv_tpu_torch.mesh.mc_tables import MAX_TRIS, NUM_TRIS, TRI_TABLE
from ssrlcv_tpu_torch.mesh.octree import _dot3, _norm3


def vertex_implicit_from_normals(
    hier: OctreeHierarchy,
    normals,                      # (P, 3) per sorted point (hier.points order)
    levels: slice | None = None,  # vertex range; default all
    device=None,
    max_elements: int = 1 << 25,
) -> np.ndarray:
    """Implicit value per octree vertex: dot(unit normal of nearest point,
    unit vector nearest-point -> vertex).  Negative is "inside".  Runs on
    ``device`` (None: the device of a tensor ``normals``, else ``cuda:0``)
    in row chunks of at most ``max_elements`` vertex-point pairs."""
    if device is None and isinstance(normals, torch.Tensor):
        device = normals.device
    dev = resolve_device(device)
    verts = hier.vertex_coord if levels is None else hier.vertex_coord[levels]
    v = torch.as_tensor(verts, device=dev)
    p = torch.as_tensor(hier.points, device=dev)
    nrm = torch.as_tensor(normals, device=dev).to(torch.float32)
    p_sq = _dot3(p, p)
    rows = max(1, max_elements // max(p.shape[0], 1))
    out = []
    for s0 in range(0, v.shape[0], rows):
        vc = v[s0:s0 + rows]
        vp = (vc[:, None, 0] * p[None, :, 0] + vc[:, None, 1] * p[None, :, 1]) \
            + vc[:, None, 2] * p[None, :, 2]
        d2 = (_dot3(vc, vc)[:, None] + p_sq[None, :]) - 2.0 * vp
        nearest = torch.argmin(d2, dim=1)
        n0 = nrm[nearest]
        n0 = n0 / torch.clamp(_norm3(n0), min=1e-12)[:, None]
        vec = vc - p[nearest]
        vec = vec / torch.clamp(_norm3(vec), min=1e-12)[:, None]
        out.append(_dot3(n0, vec))
    return torch.cat(out).cpu().numpy()


def _emit(hier: OctreeHierarchy, node_ids: np.ndarray, categories: np.ndarray):
    """Emit (surface_vertices, triangles) for the given nodes/categories.

    Surface vertices are deduplicated crossed-edge midpoints (the union of
    edges referenced by any emitted triangle — minimizeVertices semantics,
    MeshFactory.cu:2168-2194)."""
    nt = NUM_TRIS[categories]                          # (M,)
    tri_edges_local = TRI_TABLE[categories]            # (M, 15) edge slots
    valid = np.arange(MAX_TRIS * 3)[None, :] < (nt * 3)[:, None]
    ge = hier.node_edges[node_ids]                     # (M, 12) global edge ids
    tri_edges = np.where(valid, np.take_along_axis(
        ge, np.maximum(tri_edges_local, 0).astype(np.int64), axis=1), -1)
    flat = tri_edges[valid]                            # (3*T,) global edge ids
    used_edges, inv = np.unique(flat, return_inverse=True)
    ev = hier.edge_v[used_edges]                       # (U, 2) lattice vertex ids
    surf_verts = 0.5 * (hier.vertex_coord[ev[:, 0]] + hier.vertex_coord[ev[:, 1]])
    tris = inv.reshape(-1, 3).astype(np.int32)
    return surf_verts.astype(np.float32), tris


def _categories_for(hier: OctreeHierarchy, node_ids: np.ndarray,
                    imp: np.ndarray) -> np.ndarray:
    """8-bit corner-sign category per node (inside = implicit < 0)."""
    nv = hier.node_vertices[node_ids]                  # (M, 8)
    signs = (imp[nv] < 0.0).astype(np.int64)
    return (signs << np.arange(8)[None, :]).sum(axis=1)


def marching_cubes_level(hier: OctreeHierarchy, imp: np.ndarray, level: int):
    """March one octree level's cubes (marchingCubes at the finest level,
    jaxMeshing at a coarser one).  imp is indexed by GLOBAL vertex id."""
    s, e = int(hier.node_level_start[level]), int(hier.node_level_start[level + 1])
    node_ids = np.arange(s, e)
    cats = _categories_for(hier, node_ids, imp)
    return _emit(hier, node_ids, cats)


def find_surface_level(hier: OctreeHierarchy) -> int:
    """Smallest level (0 = finest) at which every occupied node has at least
    one occupied 26-neighbor — "the depth at which the surface is surrounded
    by nodes without holes" (jaxMeshing scan, MeshFactory.cu:1036-1071)."""
    occ = hier.node_num_points > 0
    for level in range(hier.depth):
        s, e = int(hier.node_level_start[level]), int(hier.node_level_start[level + 1])
        ids = np.arange(s, e)[occ[s:e]]
        if ids.size == 0:
            continue
        nb = hier.node_neighbors[ids]                  # (n, 27)
        nb_occ = (nb >= 0) & occ[np.maximum(nb, 0)]
        nb_occ[:, 13] = False                          # skip self (neigh 13)
        if bool(nb_occ.any(axis=1).all()):
            return level
    return hier.depth - 1


def jax_meshing(hier: OctreeHierarchy, normals, device=None):
    """Surface-depth search + marching cubes (jaxMeshing,
    MeshFactory.cu:1015-1211).  Returns (verts, tris, surface_level)."""
    level = find_surface_level(hier)
    imp = vertex_implicit_from_normals(hier, normals, device=device)
    verts, tris = marching_cubes_level(hier, imp, level)
    return verts, tris, level


def adaptive_marching_cubes(hier: OctreeHierarchy, normals, device=None):
    """Top-down adaptive refinement (adaptiveMarchingCubes +
    categorizeCubesRecursively, MeshFactory.cu:716-858, 2109-2167): start at
    the root's children; descend into a node's children whenever they emit
    at least as many triangles together as the parent alone."""
    imp = vertex_implicit_from_normals(hier, normals, device=device)
    selected: list[int] = []
    root = int(hier.node_level_start[hier.depth])
    stack = [int(c) for c in hier.node_children[root] if c >= 0]
    while stack:
        nid = stack.pop()
        cat = int(_categories_for(hier, np.asarray([nid]), imp)[0])
        my_tris = int(NUM_TRIS[cat])
        children = hier.node_children[nid]
        children = children[children >= 0]
        if children.size:
            ccats = _categories_for(hier, children, imp)
            if int(NUM_TRIS[ccats].sum()) >= my_tris:
                stack.extend(int(c) for c in children)
                continue
        if my_tris:
            selected.append(nid)
    if not selected:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    node_ids = np.asarray(selected)
    cats = _categories_for(hier, node_ids, imp)
    return _emit(hier, node_ids, cats)
