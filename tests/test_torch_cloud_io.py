"""The port's cloud ops, debug writers, small I/O and reference features
against the JAX package, on the CPU.

Files written from the same arrays are compared byte for byte; a PLY's
``comment`` line names the package that wrote it and is the one line left
out of the comparison.  Cloud transforms agree within 1e-6 relative; the
linear errors of the sensitivity sweeps within 1e-5 relative (the two
packages round the 2-view midpoints differently); anatomy files,
csv / match / bcp files and ``features_from_refdata`` exactly.
"""

import io
import os

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import _two_view_terrain

torch.set_num_threads(2)

ANATOMY = os.path.join(os.path.dirname(__file__), "data", "anatomy_seed_features.txt")


def _without_comment(path) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n")
    head = b"".join(line for line in data[:end].splitlines(keepends=True)
                    if not line.startswith(b"comment "))
    return head + data[end:]


def _same_file(a, b):
    assert _without_comment(a) == _without_comment(b)


# --- cloud ops -------------------------------------------------------------------

def test_cloud_ops_round_trip():
    import jax.numpy as jnp

    from ssrlcv_tpu.geometry import cloud_ops as J
    from ssrlcv_tpu_torch.geometry import cloud_ops as T

    pts = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    tp = torch.from_numpy(pts)
    out = T.translate_cloud(T.scale_cloud(tp, 2.0), torch.tensor([1.0, 0, 0]))
    np.testing.assert_allclose(out.numpy(), pts * 2 + [1, 0, 0], rtol=1e-6)
    rot = T.rotate_cloud(tp, torch.tensor([0.0, 0.0, np.pi / 2]))
    np.testing.assert_allclose(rot.numpy()[:, 0], -pts[:, 1], atol=1e-5)
    mask = np.ones(32, bool)
    mask[::3] = False
    avg = T.cloud_average(tp, torch.from_numpy(mask))
    np.testing.assert_allclose(avg.numpy(), pts[mask].mean(0), atol=1e-5)
    jp = jnp.asarray(pts)
    angles = np.array([0.3, -0.2, 1.1], np.float32)
    for got, want in ((T.rotate_cloud(tp, torch.from_numpy(angles)),
                       J.rotate_cloud(jp, jnp.asarray(angles))),
                      (avg, J.cloud_average(jp, jnp.asarray(mask))),
                      (out, J.translate_cloud(J.scale_cloud(jp, 2.0), jnp.array([1.0, 0, 0])))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _clouds():
    """The port's and the JAX package's 2-view cloud, bundles, matches and
    cameras of the seeded terrain pair."""
    from ssrlcv_tpu.geometry.bundles import generate_bundles as jb
    from ssrlcv_tpu.geometry.triangulation import two_view_triangulate as jt
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import two_view_triangulate

    (tm, tc), (jm, jc) = _two_view_terrain()
    tbd, jbd = generate_bundles(tm, tc), jb(jm, jc)
    return (two_view_triangulate(tbd)[0], tbd, tm, tc), (jt(jbd)[0], jbd, jm, jc)


def test_debug_cloud_writers(tmp_path):
    """save_debug_cloud / save_linear_error_cloud / save_view_number_cloud
    write the JAX package's files for the same arrays (the port's cloud
    and bundles handed to both)."""
    import jax.numpy as jnp

    from ssrlcv_tpu.core.types import Bundles as JBundles
    from ssrlcv_tpu.core.types import Cameras as JCameras
    from ssrlcv_tpu.core.types import MatchSet as JMatchSet
    from ssrlcv_tpu.core.types import PointCloud as JCloud
    from ssrlcv_tpu.geometry import cloud_ops as J
    from ssrlcv_tpu_torch.geometry import cloud_ops as T
    from ssrlcv_tpu_torch.io import ply

    (pc, bd, ms, cams), _ = _clouds()

    def jax_of(cls, obj):
        return cls(**{k: jnp.asarray(v) for k, v in obj.to_numpy().items()})

    jpc, jbd = jax_of(JCloud, pc), jax_of(JBundles, bd)
    jms, jcams = jax_of(JMatchSet, ms), jax_of(JCameras, cams)
    for name, tcall, jcall in (
            ("debug", lambda p: T.save_debug_cloud(p, pc, cams, bd),
             lambda p: J.save_debug_cloud(p, jpc, jcams, jbd)),
            ("debug_nobundles", lambda p: T.save_debug_cloud(p, pc, cams),
             lambda p: J.save_debug_cloud(p, jpc, jcams)),
            ("error", lambda p: T.save_linear_error_cloud(p, pc),
             lambda p: J.save_linear_error_cloud(p, jpc)),
            ("views", lambda p: T.save_view_number_cloud(p, pc, ms),
             lambda p: J.save_view_number_cloud(p, jpc, jms))):
        tp, jp = tcall(str(tmp_path / f"t_{name}")), jcall(str(tmp_path / f"j_{name}"))
        _same_file(tp, jp)
        back = ply.read_ply(tp)
        assert back["colors"] is not None and len(back["points"]) >= int(pc.mask.sum())
    back = ply.read_ply(str(tmp_path / "t_debug.ply"))
    assert len(back["points"]) == int(pc.mask.sum()) + 2 + 2 * int(bd.mask.sum())


def test_sensitivity_sweeps(tmp_path):
    """Six CSV sweeps of camera 1's parameters: the JAX package's offsets,
    its linear errors within 1e-5 relative, smallest near offset 0."""
    from ssrlcv_tpu.geometry.cloud_ops import generate_sensitivity_functions as jax_sweeps
    from ssrlcv_tpu_torch.geometry.cloud_ops import generate_sensitivity_functions

    (_, _, ms, cams), (_, _, jms, jcams) = _clouds()
    deltas = np.linspace(-1e-4, 1e-4, 5)
    out = generate_sensitivity_functions(ms, cams, str(tmp_path / "t"), deltas=deltas)
    jout = jax_sweeps(jms, jcams, str(tmp_path / "j"), deltas=deltas)
    assert list(out) == list(jout) and len(out) == 6
    for name in out:
        rows = open(out[name]).read().strip().splitlines()
        jrows = open(jout[name]).read().strip().splitlines()
        assert rows[0] == jrows[0] == "offset,linear_error" and len(rows) == 6
        got = np.array([[float(v) for v in r.split(",")] for r in rows[1:]])
        want = np.array([[float(v) for v in r.split(",")] for r in jrows[1:]])
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5)
        assert got[2, 1] <= got[:, 1].max()


def test_ba_noise_injection():
    """The BA self-test: the clean error equals the JAX package's (1e-5
    relative); the noise (from a torch.Generator) raises it and BA does not
    raise it further.  The draws differ from the JAX key's, so the port's
    BA also starts from the JAX self-test's noisy cameras, where both
    recover to the same error (1e-5 relative)."""
    import jax

    from ssrlcv_tpu.geometry.cloud_ops import test_bundle_adjustment_noise as jax_noise
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust_two_view
    from ssrlcv_tpu_torch.geometry.cloud_ops import test_bundle_adjustment_noise

    (_, _, ms, cams), (_, _, jms, jcams) = _clouds()
    noise = dict(noise_rot=5e-5, noise_pos=0.005, iterations=15)
    clean, noisy, recovered = test_bundle_adjustment_noise(
        ms, cams, torch.Generator().manual_seed(0), **noise)
    assert noisy > clean and recovered <= noisy
    key = jax.random.PRNGKey(0)
    jclean, jnoisy, jrecovered = jax_noise(jms, jcams, key, **noise)
    assert clean == pytest.approx(jclean, rel=1e-5)
    assert jnoisy > jclean and jrecovered < jnoisy

    k1, k2 = jax.random.split(key)
    rot, pos = cams.cam_rot.clone(), cams.cam_pos.clone()
    rot[1] += torch.from_numpy(np.asarray(noise["noise_rot"] * jax.random.normal(k1, (3,))))
    pos[1] += torch.from_numpy(np.asarray(noise["noise_pos"] * jax.random.normal(k2, (3,))))
    r = bundle_adjust_two_view(ms, cams.replace(cam_rot=rot, cam_pos=pos), iterations=15,
                               mode="lm")
    assert float(r.initial_error) == pytest.approx(jnoisy, rel=1e-5)
    assert float(r.final_error) == pytest.approx(jrecovered, rel=1e-5)


# --- csv / match / bcp files --------------------------------------------------------

def test_csv_round_trip(tmp_path):
    from ssrlcv_tpu.io import csvio as J
    from ssrlcv_tpu_torch.io.csvio import read_csv, write_csv

    vals = [1.5, 2.5, (3, 4), np.array([5.25, 6.0])]
    p = write_csv(vals, str(tmp_path / "t"), header="a,b")
    rows = read_csv(p)
    assert rows[0] == ["a", "b"] and rows[1] == ["1.5"] and rows[3] == ["3", "4"]
    jp = J.write_csv(vals, str(tmp_path / "j"), header="a,b")
    assert open(p, "rb").read() == open(jp, "rb").read()
    assert rows == J.read_csv(jp)


@pytest.mark.parametrize("binary", [True, False])
def test_match_file_round_trip(tmp_path, binary):
    from ssrlcv_tpu.io import csvio as J
    from ssrlcv_tpu_torch.io.csvio import read_match_file, write_match_file

    rng = np.random.default_rng(1)
    l0 = rng.uniform(0, 1000, (50, 2)).astype(np.float32)
    l1 = rng.uniform(0, 1000, (50, 2)).astype(np.float32)
    p = write_match_file(l0, l1, str(tmp_path / "t"), binary=binary)
    jp = J.write_match_file(l0, l1, str(tmp_path / "j"), binary=binary)
    assert open(p, "rb").read() == open(jp, "rb").read()
    a, b = read_match_file(p, binary=binary)
    np.testing.assert_allclose(a, l0, rtol=1e-6)
    np.testing.assert_allclose(b, l1, rtol=1e-6)


def test_bcp_round_trip(tmp_path):
    from ssrlcv_tpu.io import csvio as J
    from ssrlcv_tpu_torch.io.csvio import read_bcp, write_bcp

    cams = [{"cam_pos": [1.0, 2.0, 3.0], "cam_rot": [0.1, 0.2, 0.3], "fov": [0.04, 0.04],
             "foc": 0.86, "dpix": [3.5e-5, 3.5e-5], "timestamp": 1234},
            {"cam_pos": [-4.0, 5.5, 6.0], "cam_rot": [0.0, 0.1, 0.0], "fov": [0.02, 0.03],
             "foc": 0.5, "dpix": [1e-5, 2e-5]}]
    p = write_bcp(str(tmp_path / "t.bcp"), cams)
    jp = J.write_bcp(str(tmp_path / "j.bcp"), cams)
    assert open(p, "rb").read() == open(jp, "rb").read()
    back = read_bcp(p)
    np.testing.assert_allclose(back[0]["cam_pos"], cams[0]["cam_pos"])
    assert back[0]["timestamp"] == 1234 and back[1]["timestamp"] == 0
    for a, b in zip(back, J.read_bcp(p)):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


# --- anatomy and reference features ------------------------------------------------

def test_anatomy_reader():
    from ssrlcv_tpu.io import anatomy as J
    from ssrlcv_tpu_torch.io.anatomy import read_features, read_matches

    desc = " ".join(str(i % 256) for i in range(128))
    text = f"10.5 20.5 1.5 0.7 {desc}\n30.0 40.0 2.0 1.1 {desc}\nshort line\n"
    f = read_features(io.StringIO(text))
    assert f["loc"].shape == (2, 2) and f["values"][0][5] == 5
    np.testing.assert_allclose(f["loc"][0], [10.5, 20.5])
    m = read_matches(io.StringIO("1 2 3 4 5 6 7 8\n"))
    np.testing.assert_allclose(m["loc0"][0], [1, 2])
    np.testing.assert_allclose(m["loc1"][0], [5, 6])
    for got, want in ((f, J.read_features(io.StringIO(text))),
                      (m, J.read_matches(io.StringIO("1 2 3 4 5 6 7 8\n")))):
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_anatomy_real_scale_file(tmp_path):
    """The in-repo 2,000-keypoint anatomy file: the port reads the JAX
    package's arrays, its writer reproduces the file verbatim, and the
    match writer equals the JAX one."""
    from ssrlcv_tpu.io import anatomy as J
    from ssrlcv_tpu_torch.io.anatomy import read_features, write_features, write_matches

    f = read_features(ANATOMY)
    jf = J.read_features(ANATOMY)
    assert f["loc"].shape[0] == 2000
    for key in jf:
        np.testing.assert_array_equal(f[key], jf[key])
    buf = io.StringIO()
    write_features(buf, f["loc"], f["sigma"], f["theta"], f["values"])
    with open(ANATOMY) as fh:
        assert buf.getvalue() == fh.read()
    args = (f["loc"][:50], f["sigma"][:50], f["theta"][:50], f["loc"][50:100],
            f["sigma"][50:100], f["theta"][50:100])
    write_matches(str(tmp_path / "t.txt"), *args)
    J.write_matches(str(tmp_path / "j.txt"), *args)
    assert open(tmp_path / "t.txt").read() == open(tmp_path / "j.txt").read()


def test_features_from_refdata():
    """The anatomy file's features as a FeatureSet on the CPU equal the JAX
    package's field by field, at the default capacity (rounded up to 128)
    and at an explicit one with a parent id."""
    from ssrlcv_tpu.features.sift import features_from_refdata as jax_fr
    from ssrlcv_tpu_torch.features.sift import features_from_refdata
    from ssrlcv_tpu_torch.io.anatomy import read_features

    f = read_features(ANATOMY)
    for kw in ({}, {"capacity": 4096, "parent": 3}):
        got = features_from_refdata(f, device="cpu", **kw)
        want = jax_fr(f, **kw)
        assert got.capacity == (kw.get("capacity") or 2048) and got.loc.device.type == "cpu"
        for name, arr in got.to_numpy().items():
            w = np.asarray(getattr(want, name))
            assert arr.dtype == w.dtype, name
            np.testing.assert_array_equal(arr, w, err_msg=name)


# --- PLY ---------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_ply_colors_faces_edges_gradient(tmp_path, binary):
    """Points with colours, normals and triangle or quad faces, the
    wireframe writer (with a cloud prepended) and the gradient writer give
    the JAX package's files (comment line aside), and each package reads
    the other's."""
    from ssrlcv_tpu.io import ply as J
    from ssrlcv_tpu_torch.io import ply as T

    rng = np.random.default_rng(7)
    pts = rng.normal(0, 100, (40, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    tri = rng.integers(0, 40, (25, 3)).astype(np.int32)
    quad = rng.integers(0, 40, (10, 4)).astype(np.int32)
    cases = {"colors": dict(colors=cols), "faces": dict(faces=tri),
             "colors_quads": dict(colors=cols, faces=quad),
             "normals_colors_faces": dict(normals=nrm, colors=cols, faces=tri)}
    for name, kw in cases.items():
        tp = T.write_ply(str(tmp_path / f"t_{name}"), pts, binary=binary, **kw)
        jp = J.write_ply(str(tmp_path / f"j_{name}"), pts, binary=binary, **kw)
        _same_file(tp, jp)
        for got in (T.read_ply(tp), T.read_ply(jp)):
            want = J.read_ply(jp)
            for key in ("points", "colors", "normals", "faces"):
                if want[key] is None:
                    assert got[key] is None, (name, key)
                else:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    verts = rng.normal(size=(12, 3)).astype(np.float32)
    edges = rng.integers(0, 12, (20, 2))
    for extra in ({}, {"points": pts}):
        tp = T.write_ply_edges(str(tmp_path / "t_edges"), verts, edges, binary=binary, **extra)
        jp = J.write_ply_edges(str(tmp_path / "j_edges"), verts, edges, binary=binary, **extra)
        assert open(tp, "rb").read() == open(jp, "rb").read()
    vals = rng.uniform(-3, 7, 40).astype(np.float32)
    tp = T.write_ply_gradient(str(tmp_path / "t_grad"), pts, vals, binary=binary)
    jp = J.write_ply_gradient(str(tmp_path / "j_grad"), pts, vals, binary=binary)
    _same_file(tp, jp)
    back = T.read_ply(tp)["colors"]
    assert tuple(back[np.argmin(vals)]) == (0, 0, 255) and tuple(back[np.argmax(vals)]) == (255, 0, 0)
