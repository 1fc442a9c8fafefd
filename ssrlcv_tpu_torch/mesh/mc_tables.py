"""Marching-cubes case tables, generated programmatically.

The port's own copy of ``ssrlcv_tpu/mesh/mc_tables.py`` (numpy only).

The reference ships 256-entry constant tables (cubeCategoryEdgeIdentity,
numTrianglesInCubeCategory, cubeCategoryTrianglesFromEdges — used by
determineCubeCategories / generateSurfaceTriangles, MeshFactory.cu:2195-2255).
Instead of transcribing those constants, this module derives an equivalent
table from first principles at import time, in the repo's own corner/edge
numbering (hierarchy.CORNER_OFFSETS / hierarchy.EDGE_CORNERS):

For each of the 256 inside/outside corner configurations, the isosurface
crosses exactly the edges whose endpoints differ in sign.  On each cube face
the crossed edges pair up so that each maximal run of *inside* corners along
the face's boundary cycle is fenced by one pair — which also fixes the
standard resolution of the ambiguous 4-crossing face (diagonal inside
corners stay separated).  Each crossed edge thus gets exactly two pairings
(one per adjacent face), so crossed edges form disjoint cycles = the surface
polygons, which are fan-triangulated with outward (inside -> outside)
orientation.

Differences vs the reference, by design: the category index is the corner
sign mask itself (the reference categorizes by matching the *edge* mask
against its table and taking the first hit, which collapses complementary
configurations — MeshFactory.cu:2203-2214), and triangles within a category
may be listed in a different order.  The emitted surface is the same.
"""

from __future__ import annotations

import numpy as np

from ssrlcv_tpu_torch.mesh.hierarchy import CORNER_OFFSETS, EDGE_CORNERS

MAX_TRIS = 5  # a marching-cubes cell emits at most 5 triangles

# 6 faces as (axis, side): corners with offset[axis] == side
_FACES = [(a, s) for a in range(3) for s in (0, 1)]


def _face_cycle(axis: int, side: int) -> list[int]:
    """Corner ids of a face in cyclic (boundary) order."""
    ids = [c for c in range(8) if CORNER_OFFSETS[c, axis] == side]
    other = [a for a in range(3) if a != axis]
    uv = CORNER_OFFSETS[ids][:, other]               # (4, 2) in {0,1}
    ang = np.arctan2(uv[:, 1] - 0.5, uv[:, 0] - 0.5)
    return [ids[i] for i in np.argsort(ang)]


_FACE_CYCLES = [_face_cycle(a, s) for a, s in _FACES]
_EDGE_ID = {tuple(sorted(e)): i for i, e in enumerate(EDGE_CORNERS.tolist())}


def _build_tables():
    tri_table = np.full((256, MAX_TRIS * 3), -1, np.int8)
    n_tris = np.zeros(256, np.int32)
    edge_mask = np.zeros(256, np.int32)
    corner_pos = CORNER_OFFSETS.astype(np.float64)
    edge_mid = corner_pos[EDGE_CORNERS].mean(axis=1)  # (12, 3)

    for cfg in range(256):
        inside = [(cfg >> c) & 1 == 1 for c in range(8)]
        crossed = [inside[a] != inside[b] for a, b in EDGE_CORNERS]
        edge_mask[cfg] = sum(1 << e for e in range(12) if crossed[e])
        if not any(crossed):
            continue
        # pair crossed edges per face: each run of inside corners along the
        # boundary cycle is fenced by the crossed edges at its two ends
        pairs: dict[int, list[int]] = {e: [] for e in range(12) if crossed[e]}
        for cyc in _FACE_CYCLES:
            cyc_edges = [_EDGE_ID[tuple(sorted((cyc[i], cyc[(i + 1) % 4])))] for i in range(4)]
            xs = [i for i in range(4) if crossed[cyc_edges[i]]]
            if not xs:
                continue
            # walk the 4 boundary corners; an inside-run [i..j] is fenced by
            # edge (i-1 -> i) and edge (j -> j+1)
            for i in range(4):
                if inside[cyc[i]] and not inside[cyc[(i - 1) % 4]]:
                    j = i
                    while inside[cyc[(j + 1) % 4]]:
                        j += 1
                    e_in = cyc_edges[(i - 1) % 4]
                    e_out = cyc_edges[j % 4]
                    pairs[e_in].append(e_out)
                    pairs[e_out].append(e_in)
        # trace cycles -> polygons
        polys = []
        todo = {e for e in pairs}
        while todo:
            start = min(todo)
            poly = [start]
            todo.remove(start)
            prev, cur = None, start
            while True:
                nxts = [x for x in pairs[cur] if x != prev]
                nxt = nxts[0] if nxts else pairs[cur][0]
                if nxt == start:
                    break
                poly.append(nxt)
                todo.remove(nxt)
                prev, cur = cur, nxt
            polys.append(poly)
        # orient each polygon outward (inside -> outside) and fan-triangulate
        g_in = corner_pos[[c for c in range(8) if inside[c]]].mean(axis=0)
        g_out = corner_pos[[c for c in range(8) if not inside[c]]].mean(axis=0)
        grad = g_out - g_in
        tris = []
        for poly in polys:
            pts = edge_mid[poly]
            n = np.zeros(3)
            for i in range(1, len(poly) - 1):
                n += np.cross(pts[i] - pts[0], pts[i + 1] - pts[0])
            if np.dot(n, grad) < 0:
                poly = poly[::-1]
            for i in range(1, len(poly) - 1):
                tris.extend([poly[0], poly[i], poly[i + 1]])
        n_tris[cfg] = len(tris) // 3
        tri_table[cfg, : len(tris)] = tris
    return tri_table, n_tris, edge_mask


TRI_TABLE, NUM_TRIS, EDGE_MASK = _build_tables()
