"""Multi-depth octree hierarchy: node/vertex/edge/face arrays + 27-neighborhoods.

The port's own copy of ``ssrlcv_tpu/mesh/hierarchy.py``: the host-side numpy
construction is the same code; ``knn_neighborhood`` searches in torch.

TPU re-design of the reference Octree's full hierarchy (Octree.cuh:56-165;
construction Octree.cu:356-620 createFinestNodes/fillInCoarserDepths/
fillNeighborhoods, VEF arrays Octree.cu:624-1123).  The reference builds a
pointer-linked Node graph on the GPU with thrust compactions and a 216-entry
parent/child LUT walk for neighborhoods; none of that is MXU work, so here
the hierarchy is constructed once, host-side, with vectorized numpy — sorted
Morton keys per depth, full 8-sibling groups (blank siblings included, as the
reference allocates them in fillBlankNodeArray), and neighborhoods by direct
grid-coordinate key lookup, which is semantically identical to the LUT walk.
The outputs are flat, static-shape arrays that feed jitted consumers
(implicit surface values, marching cubes) and kNN gathers.

Conventions (all matching the reference):
  - cubic bounding box: width = even-ceil(max extent) + 6 (Octree.cu:190-198)
  - Morton keys interleave x as the most significant bit of each 3-bit level
    group (getNodeKeys, Octree.cu:1975-2010)
  - corner index c in [0,8): bits (x,y,z) = (c>>2, c>>1, c>>0) & 1, i.e. the
    coordPlacementIdentity ordering (Octree.cuh:247-256)
  - 12 edges / 6 faces per node use the vertexEdgeIdentity /
    edgeFaceIdentity orderings (Octree.cuh:257-285)
  - node arrays are level-major with the FINEST level first, like the
    reference's nodeDepthIndex (fillInCoarserDepths, Octree.cu:445-530);
    ``node_level_start[l]`` is the first node of level l (0 = finest)
  - neighbors[27]: index (dx+1)*9 + (dy+1)*3 + (dz+1); 13 is self
    (jaxMeshing's hole test skips neigh==13, MeshFactory.cu:1050)
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 12 cube edges as corner-index pairs (vertexEdgeIdentity, Octree.cuh:257-269)
EDGE_CORNERS = np.array(
    [[0, 1], [0, 2], [1, 3], [2, 3],
     [0, 4], [1, 5], [2, 6], [3, 7],
     [4, 5], [4, 6], [5, 7], [6, 7]], np.int64)
# 6 cube faces as edge-index quadruples (edgeFaceIdentity, Octree.cuh:277-285)
FACE_EDGES = np.array(
    [[0, 1, 2, 3], [0, 4, 5, 8], [1, 4, 6, 9],
     [2, 5, 7, 10], [3, 6, 7, 11], [8, 9, 10, 11]], np.int64)
# corner index -> (x, y, z) in {0, 1}
CORNER_OFFSETS = np.stack(
    [(np.arange(8) >> 2) & 1, (np.arange(8) >> 1) & 1, np.arange(8) & 1], axis=1
).astype(np.int64)


def _spread3(v: np.ndarray) -> np.ndarray:
    """Insert 2 zero bits between each of the low 10 bits."""
    v = v.astype(np.uint64) & np.uint64(0x3FF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x30000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x300F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x9249249)
    return v


def interleave_xyz(g: np.ndarray) -> np.ndarray:
    """Morton key with x most significant per level group (getNodeKeys
    pushes x, then y, then z each level — Octree.cu:1985-2009)."""
    return (_spread3(g[..., 0]) << np.uint64(2)) | (_spread3(g[..., 1]) << np.uint64(1)) | _spread3(g[..., 2])


def deinterleave_xyz(key: np.ndarray, depth: int) -> np.ndarray:
    """Inverse of interleave_xyz: (..., 3) grid coordinates at `depth`."""
    key = key.astype(np.uint64)
    out = np.zeros(key.shape + (3,), np.int64)
    for lvl in range(depth):
        sh = np.uint64(3 * lvl)
        out[..., 2] |= ((key >> sh) & np.uint64(1)).astype(np.int64) << lvl
        out[..., 1] |= ((key >> (sh + np.uint64(1))) & np.uint64(1)).astype(np.int64) << lvl
        out[..., 0] |= ((key >> (sh + np.uint64(2))) & np.uint64(1)).astype(np.int64) << lvl
    return out


@dataclasses.dataclass
class OctreeHierarchy:
    """Flat multi-depth octree arrays (host numpy).

    Nodes are level-major, finest level first.  A node with no points is a
    "blank" sibling (numPoints == 0) exactly as in fillBlankNodeArray
    (Octree.cu:2030-2100); every non-root node exists inside a full group of
    8 siblings.
    """

    depth: int
    center: np.ndarray          # (3,)
    width: float                # cubic bounding box width
    points: np.ndarray          # (P, 3) valid points sorted by finest key
    order: np.ndarray           # (P,) indices into the original point array

    # --- nodes ---
    node_key: np.ndarray        # (N,) uint64 Morton key at the node's depth
    node_depth: np.ndarray      # (N,) actual depth d (0 = root, depth = finest)
    node_center: np.ndarray     # (N, 3)
    node_width: np.ndarray      # (N,)
    node_point_index: np.ndarray  # (N,) first point (sorted order), -1 if none
    node_num_points: np.ndarray   # (N,)
    node_parent: np.ndarray     # (N,)
    node_children: np.ndarray   # (N, 8) -1 where absent
    node_neighbors: np.ndarray  # (N, 27) same-depth neighbors, -1 where absent
    node_vertices: np.ndarray   # (N, 8) into the vertex arrays
    node_edges: np.ndarray      # (N, 12)
    node_faces: np.ndarray      # (N, 6)
    node_level_start: np.ndarray  # (depth+2,) level l (0=finest) node range

    # --- vertices / edges / faces (deduplicated per level) ---
    vertex_coord: np.ndarray    # (V, 3)
    vertex_nodes: np.ndarray    # (V, 8) nodes sharing the vertex, -1 absent
    vertex_depth: np.ndarray    # (V,)
    vertex_level_start: np.ndarray
    edge_v: np.ndarray          # (E, 2) vertex ids
    edge_nodes: np.ndarray      # (E, 4)
    edge_depth: np.ndarray      # (E,)
    edge_level_start: np.ndarray
    face_edges: np.ndarray      # (F, 4) edge ids
    face_nodes: np.ndarray      # (F, 2)
    face_depth: np.ndarray      # (F,)
    face_level_start: np.ndarray

    point_node_index: np.ndarray  # (P,) finest node id per sorted point

    # ---- level views ----
    def level_nodes(self, level: int) -> slice:
        """Node id range of level `level` (0 = finest)."""
        return slice(int(self.node_level_start[level]), int(self.node_level_start[level + 1]))

    def level_of_depth(self, d: int) -> int:
        return self.depth - d


def build_hierarchy(points: np.ndarray, mask: np.ndarray | None = None,
                    depth: int = 8) -> OctreeHierarchy:
    """Build the full hierarchy (Octree ctor path, Octree.cu:152-219)."""
    points = np.asarray(points, np.float32)
    if mask is None:
        mask = np.ones(points.shape[0], bool)
    mask = np.asarray(mask, bool)
    pts = points[mask]
    orig_idx = np.nonzero(mask)[0].astype(np.int32)
    if pts.shape[0] == 0:
        raise ValueError("cannot build an octree over zero valid points")
    if depth > 10:
        raise ValueError("octree supports depth <= 10 (Octree.cu:210)")

    # cubic bbox, reference quirks included (even-ceil + 6, Octree.cu:190-198)
    pmin = pts.min(axis=0).astype(np.float64)
    pmax = pts.max(axis=0).astype(np.float64)
    center = (pmin + pmax) / 2.0
    width = float(np.ceil((pmax - pmin).max()))
    if int(width) % 2:
        width += 1.0
    width += 6.0
    bbox_min = center - width / 2.0

    n_cells = 1 << depth
    cell = width / n_cells
    g = np.clip(((pts.astype(np.float64) - bbox_min) / cell).astype(np.int64), 0, n_cells - 1)
    keys = interleave_xyz(g)

    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    pts = pts[order]
    orig_idx = orig_idx[order]

    uk, first, counts = np.unique(keys, return_index=True, return_counts=True)

    # ---- build per-level node groups, finest -> root ----
    # per level l (0 = finest): keys_l sorted, point_index_l, num_points_l,
    # children rows filled after the finer level is placed
    lvl_keys, lvl_pidx, lvl_np = [], [], []
    cur_keys = uk            # occupied unique keys at current depth
    cur_pidx = first.astype(np.int64)
    cur_np = counts.astype(np.int64)
    for d in range(depth, -1, -1):
        if d > 0:
            parents = np.unique(cur_keys >> np.uint64(3))
            # full sibling groups: every parent contributes 8 children
            group = (parents[:, None] << np.uint64(3)) | np.arange(8, dtype=np.uint64)[None, :]
            all_keys = group.reshape(-1)
        else:
            all_keys = np.zeros(1, np.uint64)
        # mark occupied slots
        pos = np.searchsorted(all_keys, cur_keys)
        occupied = np.full(all_keys.shape[0], -1, np.int64)
        occupied[pos] = np.arange(cur_keys.shape[0])
        pidx = np.full(all_keys.shape[0], -1, np.int64)
        npts = np.zeros(all_keys.shape[0], np.int64)
        hit = occupied >= 0
        pidx[hit] = cur_pidx[occupied[hit]]
        npts[hit] = cur_np[occupied[hit]]
        lvl_keys.append(all_keys)
        lvl_pidx.append(pidx)
        lvl_np.append(npts)
        if d > 0:
            # parent point ranges: first occupied child's pointIndex, summed count
            grp_pidx = pidx.reshape(-1, 8)
            grp_np = npts.reshape(-1, 8)
            has = grp_pidx >= 0
            big = np.where(has, grp_pidx, np.iinfo(np.int64).max)
            cur_pidx = big.min(axis=1)
            cur_np = grp_np.sum(axis=1)
            cur_keys = parents
    # level-major concat (finest first)
    sizes = [k.shape[0] for k in lvl_keys]
    node_level_start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n_total = int(node_level_start[-1])

    node_key = np.concatenate(lvl_keys)
    node_point_index = np.concatenate(lvl_pidx).astype(np.int32)
    node_num_points = np.concatenate(lvl_np).astype(np.int32)
    node_depth = np.concatenate(
        [np.full(sizes[l], depth - l, np.int32) for l in range(depth + 1)])
    node_children = np.full((n_total, 8), -1, np.int32)
    node_parent = np.full(n_total, -1, np.int32)

    # parent/child pointers: level l+1's unique parents own 8 contiguous
    # children at level l; a level-(l+1) node is a unique parent iff it is
    # occupied (blank siblings have no children, fillBlankNodeArray semantics)
    for l in range(depth):
        s_child, s_par = node_level_start[l], node_level_start[l + 1]
        n_child = sizes[l]
        par_keys = node_key[s_par:s_par + sizes[l + 1]]
        child_parent_key = node_key[s_child:s_child + n_child] >> np.uint64(3)
        pi = np.searchsorted(par_keys, child_parent_key)
        node_parent[s_child:s_child + n_child] = (s_par + pi).astype(np.int32)
        child_ids = np.arange(s_child, s_child + n_child, dtype=np.int32).reshape(-1, 8)
        octant = (node_key[s_child:s_child + n_child] & np.uint64(7)).astype(np.int64).reshape(-1, 8)
        parents_of_groups = node_parent[s_child:s_child + n_child].reshape(-1, 8)[:, 0]
        node_children[parents_of_groups[:, None], octant] = child_ids

    # centers / widths
    node_center = np.empty((n_total, 3), np.float32)
    node_width = np.empty(n_total, np.float32)
    for l in range(depth + 1):
        d = depth - l
        s = node_level_start[l]
        w = width / (1 << d)
        gg = deinterleave_xyz(node_key[s:s + sizes[l]], d)
        node_center[s:s + sizes[l]] = (bbox_min[None, :] + (gg + 0.5) * w).astype(np.float32)
        node_width[s:s + sizes[l]] = w

    # ---- 27-neighborhoods per level (fillNeighborhoods semantics) ----
    node_neighbors = np.full((n_total, 27), -1, np.int32)
    doff = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing="ij"),
                    axis=-1).reshape(27, 3)   # index = (dx+1)*9+(dy+1)*3+(dz+1)
    for l in range(depth + 1):
        d = depth - l
        s = node_level_start[l]
        k_lvl = node_key[s:s + sizes[l]]
        gg = deinterleave_xyz(k_lvl, d)
        cand = gg[:, None, :] + doff[None, :, :]            # (n, 27, 3)
        inb = np.all((cand >= 0) & (cand < (1 << d)), axis=-1)
        ck = interleave_xyz(np.clip(cand, 0, max((1 << d) - 1, 0)))
        pos = np.searchsorted(k_lvl, ck)
        pos = np.clip(pos, 0, max(sizes[l] - 1, 0))
        found = inb & (k_lvl[pos] == ck)
        node_neighbors[s:s + sizes[l]] = np.where(found, (s + pos).astype(np.int64), -1).astype(np.int32)

    # ---- vertex / edge / face arrays per level ----
    node_vertices = np.full((n_total, 8), -1, np.int32)
    node_edges = np.full((n_total, 12), -1, np.int32)
    node_faces = np.full((n_total, 6), -1, np.int32)
    v_coord, v_nodes, v_depth, v_start = [], [], [], [0]
    e_v, e_nodes, e_depth, e_start = [], [], [], [0]
    f_edges, f_nodes, f_depth, f_start = [], [], [], [0]
    for l in range(depth + 1):
        d = depth - l
        s = node_level_start[l]
        n_lvl = sizes[l]
        w = width / (1 << d)
        gg = deinterleave_xyz(node_key[s:s + n_lvl], d)
        ids = np.arange(s, s + n_lvl, dtype=np.int32)

        # vertices: corner lattice points deduped; node having the vertex at
        # corner c sits in octant (7 - c) around the vertex, giving each
        # vertex at most one node per slot (computeVertexArray ownership,
        # Octree.cu:624-738)
        corner = gg[:, None, :] + CORNER_OFFSETS[None, :, :]          # (n, 8, 3)
        side = 1 << d
        flat_c = (corner[..., 0] * (side + 1) + corner[..., 1]) * (side + 1) + corner[..., 2]
        uniq_c, inv_c = np.unique(flat_c.reshape(-1), return_inverse=True)
        vbase = v_start[-1]
        vid = (vbase + inv_c.reshape(n_lvl, 8)).astype(np.int32)
        node_vertices[s:s + n_lvl] = vid
        nv = uniq_c.shape[0]
        vx = uniq_c // ((side + 1) * (side + 1))
        vy = (uniq_c // (side + 1)) % (side + 1)
        vz = uniq_c % (side + 1)
        v_coord.append((bbox_min[None, :] + np.stack([vx, vy, vz], axis=1) * w).astype(np.float32))
        vn = np.full((nv, 8), -1, np.int32)
        vn[vid.reshape(-1) - vbase, np.tile(7 - np.arange(8), n_lvl)] = np.repeat(ids, 8)
        v_nodes.append(vn)
        v_depth.append(np.full(nv, d, np.int32))
        v_start.append(vbase + nv)

        # edges: vertex-id pairs deduped (computeEdgeArray, Octree.cu:739-858)
        ev = vid[:, EDGE_CORNERS]                                      # (n, 12, 2)
        ev_sorted = np.sort(ev.reshape(-1, 2), axis=1)
        uniq_e, inv_e = np.unique(ev_sorted, axis=0, return_inverse=True)
        ebase = e_start[-1]
        eid = (ebase + inv_e.reshape(n_lvl, 12)).astype(np.int32)
        node_edges[s:s + n_lvl] = eid
        ne = uniq_e.shape[0]
        e_v.append(uniq_e.astype(np.int32))
        en = np.full((ne, 4), -1, np.int32)
        # up to 4 nodes share an edge; slot by arrival order
        flat_e = inv_e.reshape(n_lvl, 12)
        slot_cnt = np.zeros(ne, np.int64)
        for j in range(12):
            rows = flat_e[:, j]
            en[rows, np.minimum(slot_cnt[rows], 3)] = ids
            slot_cnt[rows] += 1
        e_nodes.append(en)
        e_depth.append(np.full(ne, d, np.int32))
        e_start.append(ebase + ne)

        # faces: edge-id quadruples deduped (computeFaceArray, Octree.cu:859+)
        fe = eid[:, FACE_EDGES]                                        # (n, 6, 4)
        fe_sorted = np.sort(fe.reshape(-1, 4), axis=1)
        uniq_f, inv_f = np.unique(fe_sorted, axis=0, return_inverse=True)
        fbase = f_start[-1]
        fid = (fbase + inv_f.reshape(n_lvl, 6)).astype(np.int32)
        node_faces[s:s + n_lvl] = fid
        nf = uniq_f.shape[0]
        f_edges.append(uniq_f.astype(np.int32))
        fn = np.full((nf, 2), -1, np.int32)
        flat_f = inv_f.reshape(n_lvl, 6)
        slot_cnt = np.zeros(nf, np.int64)
        for j in range(6):
            rows = flat_f[:, j]
            fn[rows, np.minimum(slot_cnt[rows], 1)] = ids
            slot_cnt[rows] += 1
        f_nodes.append(fn)
        f_depth.append(np.full(nf, d, np.int32))
        f_start.append(fbase + nf)

    # per-point leaf node ids (pointNodeIndex, Octree.cu:471-529)
    finest_keys = node_key[: sizes[0]]
    point_node_index = np.searchsorted(finest_keys, keys).astype(np.int32)

    return OctreeHierarchy(
        depth=depth,
        center=center.astype(np.float32),
        width=width,
        points=pts,
        order=orig_idx,
        node_key=node_key,
        node_depth=node_depth,
        node_center=node_center,
        node_width=node_width,
        node_point_index=node_point_index,
        node_num_points=node_num_points,
        node_parent=node_parent,
        node_children=node_children,
        node_neighbors=node_neighbors,
        node_vertices=node_vertices,
        node_edges=node_edges,
        node_faces=node_faces,
        node_level_start=node_level_start,
        vertex_coord=np.concatenate(v_coord),
        vertex_nodes=np.concatenate(v_nodes),
        vertex_depth=np.concatenate(v_depth),
        vertex_level_start=np.asarray(v_start, np.int64),
        edge_v=np.concatenate(e_v),
        edge_nodes=np.concatenate(e_nodes),
        edge_depth=np.concatenate(e_depth),
        edge_level_start=np.asarray(e_start, np.int64),
        face_edges=np.concatenate(f_edges),
        face_nodes=np.concatenate(f_nodes),
        face_depth=np.concatenate(f_depth),
        face_level_start=np.asarray(f_start, np.int64),
        point_node_index=point_node_index,
    )


def knn_neighborhood(hier: OctreeHierarchy, k: int = 8, device=None,
                     max_elements: int = 1 << 24):
    """kNN via true 27-neighborhood candidate gathering (the reference's
    computeAverageNeighboorDistances node-walk, Octree.cu:2100+): for each
    point, candidates are the points of the 27 leaf-node neighborhood of its
    own leaf.  Exact whenever the k-th neighbor lies within one cell width.

    The candidate search runs in torch on ``device`` (None: ``cuda:0``), in
    row chunks of at most ``max_elements`` candidates.  Tied distances keep
    the lower candidate slot first (a stable sort), as ``lax.top_k`` does.

    Returns (neighbor_idx (P, k) int32 into hier.points order, dist (P, k)
    float32), torch tensors on ``device``; missing neighbors are (-1, inf).
    """
    import torch

    from ssrlcv_tpu_torch.core.device import resolve_device
    from ssrlcv_tpu_torch.mesh.octree import _norm3

    dev = resolve_device(device)
    n_finest = int(hier.node_level_start[1])
    m = int(hier.node_num_points[:n_finest].max())
    leaf = hier.point_node_index                      # (P,)
    nbrs27 = hier.node_neighbors[leaf]                # (P, 27)
    safe = np.where(nbrs27 >= 0, nbrs27, 0)
    starts = hier.node_point_index[safe]              # (P, 27)
    counts = np.where(nbrs27 >= 0, hier.node_num_points[safe], 0)

    pts = torch.as_tensor(hier.points, device=dev)
    starts_t = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    counts_t = torch.as_tensor(counts, dtype=torch.int64, device=dev)
    offs = torch.arange(m, device=dev)
    p = pts.shape[0]
    rows = max(1, max_elements // (27 * m))
    out_idx, out_d = [], []
    for s0 in range(0, p, rows):
        s1 = min(s0 + rows, p)
        valid = offs[None, None, :] < counts_t[s0:s1, :, None]
        cand = torch.where(valid, starts_t[s0:s1, :, None] + offs[None, None, :], 0)
        cand, valid = cand.reshape(s1 - s0, 27 * m), valid.reshape(s1 - s0, 27 * m)
        valid &= cand != torch.arange(s0, s1, device=dev)[:, None]
        d = _norm3(pts[cand] - pts[s0:s1, None, :])
        d = torch.where(valid, d, torch.inf)
        d, col = torch.sort(d, dim=1, stable=True)
        d, col = d[:, :k], col[:, :k]
        idx = torch.gather(cand, 1, col)
        out_idx.append(torch.where(torch.isfinite(d), idx, -1).to(torch.int32))
        out_d.append(d)
    return torch.cat(out_idx), torch.cat(out_d)
