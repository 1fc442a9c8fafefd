"""The port's mesh family and planar filter against the JAX package, on the
CPU.

Mirrors tests/test_mesh.py, tests/test_hierarchy.py and the quadtree test
of tests/test_quadtree_csv.py: each runs the port (``device="cpu"``) and
the JAX package on the same seeded input, holds the port to the JAX test's
own assertions, and compares the two.  Tolerances: Morton keys, sort
orders, neighbour indices, masks and the host-built hierarchy exact;
distances within two float32 ulps (the JAX package may fuse a
multiply-add); normals within 1e-5 (the port solves the 3x3 eigenproblems
in float64 and rounds once, jaxlib in float32); mesh vertex and face
counts exact and vertices within 1e-5 of the coordinate scale.  Neighbours with tied distances keep
the lower candidate column first in both (``lax.top_k``; a stable sort in
the port).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_hierarchy import _sphere, _terrain

torch.set_num_threads(2)

DIST_RTOL = 2.4e-7   # two float32 ulps
NORMAL_TOL = 1e-5


def _tree_pair(pts, mask=None, depth=8):
    import jax.numpy as jnp

    from ssrlcv_tpu.mesh.octree import build_octree as jax_build
    from ssrlcv_tpu_torch.mesh.octree import build_octree

    mask = np.ones(len(pts), bool) if mask is None else mask
    return (build_octree(pts, mask, depth=depth, device="cpu"),
            jax_build(jnp.asarray(pts), jnp.asarray(mask), depth=depth))


def _same_tree(tt, jt):
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys).astype(np.int64))
    np.testing.assert_array_equal(tt.order.numpy(), np.asarray(jt.order))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    np.testing.assert_array_equal(tt.points.numpy(), np.asarray(jt.points))


def _same_mesh(a, b, scale=1.0):
    """Port mesh a against JAX mesh b: counts exact, vertices within 1e-5 of
    the coordinate scale, faces equal."""
    assert a.points.shape == b.points.shape and a.faces.shape == b.faces.shape
    np.testing.assert_allclose(a.points, b.points, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(a.faces, b.faces)


# --- tests/test_mesh.py ------------------------------------------------------

def test_morton_keys_order_locality():
    pts = np.random.default_rng(0).uniform(0, 1, (512, 3)).astype(np.float32)
    tt, jt = _tree_pair(pts, depth=8)
    _same_tree(tt, jt)
    keys = tt.keys.numpy()
    assert (np.diff(keys) >= 0).all()
    p = tt.points.numpy()
    step = np.linalg.norm(np.diff(p, axis=0), axis=1)
    rand_step = np.linalg.norm(p[:-1] - p[::-1][:-1], axis=1)
    assert step.mean() < 0.5 * rand_step.mean()
    # invalid points sort to the end with the all-ones 32-bit key
    mask = np.ones(512, bool)
    mask[::7] = False
    tt, jt = _tree_pair(pts, mask)
    _same_tree(tt, jt)
    assert (tt.keys.numpy()[-int((~mask).sum()):] == 0xFFFFFFFF).all()


def test_knn_window_approximates_exact():
    from ssrlcv_tpu.mesh.octree import knn as jax_knn
    from ssrlcv_tpu.mesh.octree import knn_exact as jax_exact
    from ssrlcv_tpu_torch.mesh.octree import knn, knn_exact

    pts = np.random.default_rng(1).uniform(0, 1, (256, 3)).astype(np.float32)
    tt, jt = _tree_pair(pts)
    idx, dist = knn(tt, k=4, window=64)
    eidx, edist = knn_exact(tt.points, tt.mask, k=4)
    dist, edist = dist.numpy(), edist.numpy()
    close = np.isclose(dist, edist, atol=1e-5).all(axis=1)
    assert close.mean() > 0.75, close.mean()
    assert (dist >= edist - 1e-5).all()
    ji, jd = jax_knn(jt, k=4, window=64)
    ei, ed = jax_exact(jt.points, jt.mask, k=4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(ei))
    np.testing.assert_allclose(dist, np.asarray(jd), rtol=DIST_RTOL, atol=0)
    np.testing.assert_allclose(edist, np.asarray(ed), rtol=DIST_RTOL, atol=0)


def test_normals_on_plane():
    import jax.numpy as jnp

    from ssrlcv_tpu.mesh.octree import compute_normals as jax_normals
    from ssrlcv_tpu_torch.mesh.octree import compute_normals

    xy = np.random.default_rng(2).uniform(0, 1, (400, 2)).astype(np.float32)
    pts = np.column_stack([xy, np.zeros(400, np.float32)])
    tt, jt = _tree_pair(pts)
    cams = np.array([[0.5, 0.5, 10.0]], np.float32)
    normals = compute_normals(tt, cams, k=6, window=48).numpy()
    assert (normals[:, 2] > 0.99).mean() > 0.95  # camera-facing +z normals
    jn = np.asarray(jax_normals(jt, jnp.asarray(cams), k=6, window=48))
    np.testing.assert_allclose(normals, jn, rtol=0, atol=NORMAL_TOL)


def test_low_density_filter_drops_outlier():
    import jax.numpy as jnp

    from ssrlcv_tpu.mesh.meshfactory import filter_by_neighbor_distance as jax_filter
    from ssrlcv_tpu_torch.mesh.meshfactory import filter_by_neighbor_distance

    cluster = np.random.default_rng(3).normal(0, 0.1, (200, 3)).astype(np.float32)
    pts = np.vstack([cluster, np.array([[50.0, 50.0, 50.0]], np.float32)])
    keep = filter_by_neighbor_distance(pts, np.ones(201, bool), sigma=3.0, k=4, window=32,
                                       device="cpu").numpy()
    assert not keep[200] and keep[:200].mean() > 0.95
    want = np.asarray(jax_filter(jnp.asarray(pts), jnp.ones(201, bool), sigma=3.0, k=4,
                                 window=32))
    np.testing.assert_array_equal(keep, want)


def test_marching_tetrahedra_sphere():
    import jax.numpy as jnp

    from ssrlcv_tpu.mesh import marching_cubes as J
    from ssrlcv_tpu_torch.mesh.marching_cubes import (CORNERS, TET_EDGES, TET_TRIS, TETS,
                                                      compact_mesh, marching_tetrahedra)

    for a, b in ((TETS, J.TETS), (CORNERS, J.CORNERS), (TET_EDGES, J.TET_EDGES),
                 (TET_TRIS, J.TET_TRIS)):
        np.testing.assert_array_equal(a, np.asarray(b))
    res = 24
    ax = np.linspace(-1.2, 1.2, res).astype(np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    field = (1.0 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)).astype(np.float32)
    spacing = np.full(3, float(ax[1] - ax[0]), np.float32)
    origin = np.full(3, -1.2, np.float32)
    tris, mask = marching_tetrahedra(torch.from_numpy(field), torch.from_numpy(origin),
                                     torch.from_numpy(spacing))
    verts, faces = compact_mesh(tris, mask)
    assert len(faces) > 200
    r = np.linalg.norm(verts, axis=1)
    np.testing.assert_allclose(r.mean(), 1.0, atol=0.05)
    assert r.std() < 0.05
    jt, jm = J.marching_tetrahedra(jnp.asarray(field), jnp.asarray(origin), jnp.asarray(spacing))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tris.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    jv, jf = J.compact_mesh(np.asarray(jt), np.asarray(jm))
    assert verts.shape == jv.shape and faces.shape == jf.shape
    np.testing.assert_allclose(verts, jv, rtol=0, atol=1e-5)


def test_surface_reconstruction_plane():
    import jax.numpy as jnp

    from ssrlcv_tpu.mesh.meshfactory import reconstruct_surface as jax_recon
    from ssrlcv_tpu_torch.mesh.meshfactory import reconstruct_surface

    xy = np.random.default_rng(5).uniform(0, 1, (500, 2)).astype(np.float32)
    pts = np.column_stack([xy, 0.5 + 0.0 * xy[:, :1]]).astype(np.float32)
    cams = np.array([[0.5, 0.5, 5.0]], np.float32)
    mesh = reconstruct_surface(pts, np.ones(500, bool), cams, resolution=24, k=6, device="cpu")
    assert len(mesh.faces) > 50
    assert abs(float(np.mean(mesh.points[:, 2])) - 0.5) < 0.05
    _same_mesh(mesh, jax_recon(jnp.asarray(pts), jnp.ones(500, bool), jnp.asarray(cams),
                               resolution=24, k=6))


def test_cloud_difference_metric():
    from ssrlcv_tpu.mesh.meshfactory import average_cloud_difference as jax_diff
    from ssrlcv_tpu_torch.mesh.meshfactory import average_cloud_difference

    a = np.zeros((10, 3), np.float32)
    b = np.ones((10, 3), np.float32)
    assert abs(average_cloud_difference(torch.from_numpy(a), b) - np.sqrt(3)) < 1e-5
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(50, 3)), rng.normal(size=(70, 3))
    assert average_cloud_difference(a, b) == jax_diff(a, b)


# --- tests/test_hierarchy.py -------------------------------------------------

def test_morton_roundtrip():
    from ssrlcv_tpu.mesh import hierarchy as J
    from ssrlcv_tpu_torch.mesh.hierarchy import deinterleave_xyz, interleave_xyz

    g = np.random.default_rng(3).integers(0, 2 ** 8, (1000, 3))
    assert np.array_equal(deinterleave_xyz(interleave_xyz(g), 8), g)
    np.testing.assert_array_equal(interleave_xyz(g), J.interleave_xyz(g))


def test_hierarchy_invariants():
    """The JAX test's invariants on the port's hierarchy, and every array
    equal to the JAX package's (the construction is its numpy code)."""
    from ssrlcv_tpu.mesh.hierarchy import build_hierarchy as jax_build
    from ssrlcv_tpu_torch.mesh.hierarchy import CORNER_OFFSETS, EDGE_CORNERS, build_hierarchy

    pts = _terrain(4000)
    h = build_hierarchy(pts, depth=6)
    jh = jax_build(pts, depth=6)
    for f in dataclasses.fields(h):
        np.testing.assert_array_equal(getattr(h, f.name), getattr(jh, f.name), err_msg=f.name)
    rng = np.random.default_rng(0)
    n_finest = int(h.node_level_start[1])
    root = int(h.node_level_start[h.depth])
    assert h.node_num_points[root] == pts.shape[0]
    c = h.node_center[h.point_node_index]
    w = h.node_width[h.point_node_index][:, None]
    assert np.all(np.abs(h.points - c) <= w / 2 + 1e-3)
    for nid in rng.integers(0, n_finest, 25):
        assert nid in h.node_children[h.node_parent[nid]]
    assert n_finest % 8 == 0
    assert np.all(h.node_neighbors[:, 13] == np.arange(h.node_key.shape[0]))
    for a in rng.integers(0, n_finest, 15):
        for j in range(27):
            b = h.node_neighbors[a, j]
            if b >= 0:
                assert h.node_neighbors[b, 26 - j] == a
    for nid in rng.integers(0, n_finest, 10):
        for corner in range(8):
            assert nid in h.vertex_nodes[h.node_vertices[nid, corner]]
    for nid in rng.integers(0, n_finest, 5):
        for e_slot in range(12):
            va, vb = h.edge_v[h.node_edges[nid, e_slot]]
            ca, _ = EDGE_CORNERS[e_slot]
            expect_a = h.node_center[nid] + (CORNER_OFFSETS[ca] - 0.5) * h.node_width[nid]
            d = min(np.linalg.norm(h.vertex_coord[va] - expect_a),
                    np.linalg.norm(h.vertex_coord[vb] - expect_a))
            assert d < 1e-2 * h.node_width[nid]


def test_knn_neighborhood_accuracy_realistic():
    """The 27-neighbourhood kNN (torch) against exact kNN, the Morton-window
    kNN's measured bound, and both equal to the JAX package's (indices
    exact, distances within DIST_RTOL)."""
    from ssrlcv_tpu.mesh.hierarchy import knn_neighborhood as jax_nbhd
    from ssrlcv_tpu.mesh.octree import knn as jax_knn
    from ssrlcv_tpu_torch.mesh.hierarchy import build_hierarchy, knn_neighborhood
    from ssrlcv_tpu_torch.mesh.octree import knn, knn_exact

    pts = _terrain(12000, seed=2)
    h = build_hierarchy(pts, depth=6)
    idx, dist = knn_neighborhood(h, k=6, device="cpu", max_elements=1 << 20)
    idx, dist = idx.numpy(), dist.numpy()
    _, edist = knn_exact(torch.from_numpy(h.points), torch.ones(len(h.points), dtype=torch.bool),
                         k=6)
    edist = edist.numpy()
    finite = np.isfinite(dist)
    assert finite.mean() > 0.999
    ratio = dist[finite] / np.maximum(edist[finite], 1e-9)
    assert ratio.mean() < 1.02, f"neighborhood kNN {ratio.mean():.4f}x exact"
    assert np.median(ratio) == pytest.approx(1.0)
    ji, jd = jax_nbhd(h, k=6)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_allclose(dist, np.asarray(jd), rtol=DIST_RTOL, atol=0)

    tt, jt = _tree_pair(pts)
    _, mdist = knn(tt, k=6, window=32)
    mdist = mdist.numpy()
    _, edist2 = knn_exact(tt.points, tt.mask, k=6)
    fin2 = np.isfinite(mdist)
    ratio2 = mdist[fin2] / np.maximum(edist2.numpy()[fin2], 1e-9)
    assert ratio2.mean() < 1.3 and np.median(ratio2) < 1.05
    np.testing.assert_allclose(mdist, np.asarray(jax_knn(jt, k=6, window=32)[1]), rtol=DIST_RTOL,
                               atol=0)


def test_mc_tables_watertight_oriented():
    from collections import Counter

    from ssrlcv_tpu.mesh import mc_tables as J
    from ssrlcv_tpu_torch.mesh.hierarchy import EDGE_CORNERS
    from ssrlcv_tpu_torch.mesh.mc_tables import EDGE_MASK, MAX_TRIS, NUM_TRIS, TRI_TABLE

    for a, b in ((EDGE_MASK, J.EDGE_MASK), (NUM_TRIS, J.NUM_TRIS), (TRI_TABLE, J.TRI_TABLE)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert MAX_TRIS == J.MAX_TRIS
    assert NUM_TRIS[0] == 0 and NUM_TRIS[255] == 0 and NUM_TRIS[1] == 1
    for cfg in range(256):
        assert EDGE_MASK[cfg] == EDGE_MASK[cfg ^ 0xFF]
        for t in range(NUM_TRIS[cfg]):
            for e in TRI_TABLE[cfg, 3 * t:3 * t + 3]:
                assert EDGE_MASK[cfg] >> e & 1
    res = 10
    ax = np.linspace(-1.2, 1.2, res)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    inside = (X ** 2 + Y ** 2 + Z ** 2) < 1.0
    directed = Counter()
    for i in range(res - 1):
        for j in range(res - 1):
            for k in range(res - 1):
                cfg = 0
                for c in range(8):
                    if inside[i + ((c >> 2) & 1), j + ((c >> 1) & 1), k + (c & 1)]:
                        cfg |= 1 << c
                for t in range(NUM_TRIS[cfg]):
                    vids = []
                    for e in TRI_TABLE[cfg, 3 * t:3 * t + 3]:
                        a, b = EDGE_CORNERS[e]
                        la = (i + ((a >> 2) & 1), j + ((a >> 1) & 1), k + (a & 1))
                        lb = (i + ((b >> 2) & 1), j + ((b >> 1) & 1), k + (b & 1))
                        vids.append(tuple(sorted((la, lb))))
                    for u in range(3):
                        directed[(vids[u], vids[(u + 1) % 3])] += 1
    assert all(c == 1 for c in directed.values())


@pytest.mark.parametrize("mesher", ["marching_cubes_octree", "jax_meshing",
                                    "adaptive_marching_cubes"])
def test_octree_marching_cubes_sphere(mesher):
    """Each octree-lattice mesher on the sphere at depth 4: the JAX test's
    bounds, and the JAX package's mesh (counts exact)."""
    from ssrlcv_tpu.mesh import meshfactory as J
    from ssrlcv_tpu_torch.mesh import meshfactory as T

    pts = _sphere(2000)
    mask = np.ones(len(pts), bool)
    cams = np.array([[0.0, 0.0, 100.0]], np.float32)
    mesh = getattr(T, mesher)(pts, mask, cams, depth=4, device="cpu")
    assert mesh.faces is not None and len(mesh.faces) > 100
    r = np.linalg.norm(mesh.points, axis=1)
    assert abs(r.mean() - 10.0) < (1.5 if mesher == "adaptive_marching_cubes" else 1.0)
    if mesher == "marching_cubes_octree":
        assert r.std() < 1.5 and T.average_cloud_difference(mesh.points, pts) < 1.5
    _same_mesh(mesh, getattr(J, mesher)(pts, mask, cams, depth=4), scale=10.0)


def test_generate_mesh_and_quad_faces(tmp_path):
    from ssrlcv_tpu.io import ply as jply
    from ssrlcv_tpu_torch.io import ply
    from ssrlcv_tpu_torch.mesh.meshfactory import Mesh, generate_mesh

    pts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    quad = np.array([[0, 1, 2, 3]], np.int32)
    path = generate_mesh(Mesh(pts, faces=quad), str(tmp_path), "unit", depth=4)
    assert path.endswith("unit_mesh_march_4.ply")
    for back in (ply.read_ply(path), jply.read_ply(path)):
        assert back["faces"].shape == (1, 4)
        np.testing.assert_array_equal(back["faces"], quad)
        np.testing.assert_allclose(back["points"], pts, atol=1e-6)
    m = Mesh.load(path)
    np.testing.assert_array_equal(m.faces, quad)


def test_find_surface_level_dense_vs_sparse():
    from ssrlcv_tpu.mesh.mc_octree import find_surface_level as jax_level
    from ssrlcv_tpu_torch.mesh.hierarchy import build_hierarchy
    from ssrlcv_tpu_torch.mesh.mc_octree import find_surface_level

    dense = build_hierarchy(_sphere(4000), depth=5)
    sparse = build_hierarchy(_sphere(150, seed=7), depth=5)
    assert find_surface_level(dense) <= find_surface_level(sparse)
    assert (find_surface_level(dense), find_surface_level(sparse)) == (jax_level(dense),
                                                                       jax_level(sparse))


# --- the quadtree of tests/test_quadtree_csv.py --------------------------------

def test_quadtree_build_and_knn():
    import jax.numpy as jnp

    from ssrlcv_tpu.mesh import quadtree as J
    from ssrlcv_tpu_torch.mesh.quadtree import build_quadtree, knn_2d, node_counts_2d

    locs = np.random.default_rng(0).uniform(0, 100, (256, 2)).astype(np.float32)
    mask = np.ones(256, bool)
    mask[5] = False
    tree = build_quadtree(locs, mask, device="cpu")
    assert (np.diff(tree.keys.numpy()) >= 0).all()
    idx, dist = knn_2d(tree, k=4, window=48)
    assert np.isfinite(dist.numpy()[tree.mask.numpy()]).all()
    assert node_counts_2d(tree, 2) <= 16
    jt = J.build_quadtree(jnp.asarray(locs), jnp.asarray(mask))
    np.testing.assert_array_equal(tree.keys.numpy(), np.asarray(jt.keys).astype(np.int64))
    np.testing.assert_array_equal(tree.order.numpy(), np.asarray(jt.order))
    ji, jd = J.knn_2d(jt, k=4, window=48)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=DIST_RTOL, atol=0)
    assert node_counts_2d(tree, 2) == J.node_counts_2d(jt, 2)


# --- planar filter and plane estimate ------------------------------------------

def _two_view_terrain(seed=4, n=600):
    """A seeded terrain patch seen by two cameras 40 km up, as a 2-view
    match set (the cameras' pixels of each point, with 0.5 px of noise) and
    the cameras, in both packages; 30 tracks are lifted 5 km off the
    terrain."""
    import jax.numpy as jnp

    from ssrlcv_tpu.core.types import Cameras as JCameras
    from ssrlcv_tpu.core.types import MatchSet as JMatchSet

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-5, 5, (n, 2))
    z = 0.2 * np.sin(xy[:, 0]) + 0.1 * np.cos(xy[:, 1])
    z[:30] += 5.0
    pts = np.column_stack([xy, z])
    size, foc = 1024, 0.8593
    fov = 2 * np.arctan(12.0 / 40.0 / 2 * 1.2)
    dpix = foc * np.tan(fov / 2) / (size / 2)
    cam_pos = np.array([[-3.0, 0.0, 40.0], [3.0, 0.0, 40.0]])
    cam_rot = np.array([[np.pi, 0.0, 0.0], [np.pi, 0.0, 0.0]])   # looking down -z
    loc = np.zeros((n, 2, 2))
    for v in range(2):
        d = pts - cam_pos[v]
        R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], float)   # Rx(pi)
        c = d @ R                                                  # R^T d
        loc[:, v] = c[:, :2] / c[:, 2:3] * foc / dpix + size / 2 + rng.normal(0, 0.5, (n, 2))
    cams = dict(cam_pos=cam_pos, cam_rot=cam_rot, fov=np.full((2, 2), fov),
                foc=np.full(2, foc), dpix=np.full((2, 2), dpix), size=np.full((2, 2), size),
                ecef_offset=np.zeros((2, 3)), timestamp=np.zeros(2, np.int64))
    dtypes = dict(size=np.int32, timestamp=np.int64)
    cams = {k: np.asarray(v, dtypes.get(k, np.float32)) for k, v in cams.items()}
    ms = dict(kp_loc=loc.astype(np.float32), kp_parent=np.tile([0, 1], (n, 1)).astype(np.int32),
              num_views=np.full(n, 2, np.int32), mask=np.ones(n, bool))
    jax_pair = (JMatchSet(**{k: jnp.asarray(v) for k, v in ms.items()}),
                JCameras(**{k: jnp.asarray(v) for k, v in cams.items()}))
    from ssrlcv_tpu_torch.core.types import Cameras, MatchSet

    return (MatchSet.from_numpy(device="cpu", **ms), Cameras.from_numpy(device="cpu", **cams)), \
        jax_pair


def test_planar_cutoff_filter_matches_jax():
    """The planar filter drops the 30 lifted tracks and keeps the terrain,
    with the JAX package's mask."""
    from ssrlcv_tpu.geometry import filters as J
    from ssrlcv_tpu_torch.geometry import filters as T

    (tm, tc), (jm, jc) = _two_view_terrain()
    kept = T.planar_cutoff_filter(tm, tc, cutoff=1.0).mask.numpy()
    assert not kept[:30].any() and kept[30:].mean() > 0.95
    np.testing.assert_array_equal(kept, np.asarray(J.planar_cutoff_filter(jm, jc, cutoff=1.0).mask))


def test_visualize_plane_estimation(tmp_path):
    """The plane estimate's quad mesh: the JAX test's shape and planarity
    checks, and the JAX package's file within NORMAL_TOL (both ascii)."""
    import jax.numpy as jnp

    from ssrlcv_tpu.core.types import PointCloud as JCloud
    from ssrlcv_tpu.geometry.cloud_ops import visualize_plane_estimation as jax_vis
    from ssrlcv_tpu_torch.core.types import PointCloud
    from ssrlcv_tpu_torch.geometry.cloud_ops import visualize_plane_estimation
    from ssrlcv_tpu_torch.io.ply import read_ply

    (tm, tc), (jm, jc) = _two_view_terrain()
    pts = np.random.default_rng(9).normal(0, [50.0, 50.0, 2.0], (800, 3)).astype(np.float32)
    pts[:, 2] += 0.3 * pts[:, 0]
    cloud = PointCloud.from_numpy(device="cpu", points=pts, errors=np.zeros(800, np.float32),
                                  mask=np.ones(800, bool))
    p = visualize_plane_estimation(cloud, tc, str(tmp_path / "plane.ply"), scale=200.0)
    d = read_ply(p)
    verts, faces = d["points"], d["faces"]
    side = 2 * (200 // 40)
    assert verts.shape == (side * side, 3) and faces.shape == ((side - 1) ** 2, 4)
    n = np.cross(verts[1] - verts[0], verts[side] - verts[0])
    n = n / np.linalg.norm(n)
    assert np.abs((verts - verts[0]) @ n).max() < 1e-2
    jp = jax_vis(JCloud(points=jnp.asarray(pts), errors=jnp.zeros(800), mask=jnp.ones(800, bool)),
                 jc, str(tmp_path / "plane_jax.ply"), scale=200.0)
    jd = read_ply(jp)
    np.testing.assert_array_equal(faces, jd["faces"])
    np.testing.assert_allclose(verts, jd["points"], rtol=0, atol=1e-4)
