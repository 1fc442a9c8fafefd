"""The port's pushbroom cameras against the JAX package, on the CPU.

Mirrors tests/test_pushbroom.py (the scalar oracle, nadir geometry, the
2-view triangulation through the bundle dispatch, params.csv parsing), then
``pushbrooms_from_refimages`` on a params.csv directory, the image-0
dispatch, a 256x256 two-view pushbroom pipeline run in both packages with
mode "brute", and both command lines on that directory.

Tolerances (ROADMAP.md caveat m).  ``vec = position - (position - kp)``
recovers the ~0.012 km image-plane point through a craft position
~3,700 km from the origin, so in float32 it carries an absolute error of
up to one ulp of |position| (2.4e-4 km); one ulp of difference in a sine,
cosine or tangent between the packages moves ``position`` by about one
ulp, so the unit ray may move by 2 ulp(|position|) / |kp| (about 4 %), and the
craft position by PNT_ULPS ulps of itself.  Where the positions agree the
rays differ by a few ulps of a unit vector, and a triangulated point by two
ulps of the craft position and of each ray carried over the range and the
angle between the rays: 2 (ulp(|position|) + ulp(1) range) / sin(angle)
(``_point_tol``; 3-4 m on the 256x256 pair, whose rays meet at 4 deg some
2,700-3,200 km of range from the craft).  The 2-view errors are the squared
gaps between rays that meet to within rounding (1e-11 to 7e-7 km^2), so the
statistical filter's cutoff falls inside that rounding and the packages
keep slightly different tracks (within 2 %).  The port computes the
transcendentals in float64 rounded once, so its rays on the card equal its
CPU rays; the tests count by how many ulps the JAX package's float32
transcendentals differ from them.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_pushbroom import _matchset, _pushbrooms, _scalar_reference_ray

torch.set_num_threads(2)

PNT_ULPS = 4


def _port(cls, obj, device="cpu"):
    """A JAX pytree as the port's dataclass of the same fields."""
    return cls.from_numpy(device=device, **{f.name: np.asarray(getattr(obj, f.name))
                                            for f in dataclasses.fields(cls)})


def _ulp(x) -> float:
    return float(np.spacing(np.float32(np.max(np.abs(x)))))


def _ray_tol(pnt, pbs) -> float:
    """2 ulp(|position|) / |kp|, with the smallest image-plane point (the
    principal point's, |kp| = foc)."""
    return 2.0 * _ulp(np.linalg.norm(pnt, axis=-1)) / float(np.min(np.asarray(pbs.foc)))


def _point_tol(points, vec, pnt) -> np.ndarray:
    """Per track: 2 (ulp(|position|) + ulp(1) range) / sin(angle between
    the two rays), for points (T, 3) and their rays vec, pnt (T, 2, 3)."""
    rng_km = np.linalg.norm(points[:, None, :] - pnt, axis=-1).sum(1)
    sin_angle = np.linalg.norm(np.cross(vec[:, 0], vec[:, 1]), axis=-1)
    return (2.0 * (_ulp(np.linalg.norm(pnt, axis=-1)) + float(np.spacing(np.float32(1.0))) * rng_km)
            / np.maximum(sin_angle, 1e-6))


def _transcendental_ulps(rolls) -> int:
    """Largest ulp gap between the JAX package's float32 tan/sin/cos of the
    rolls and the correctly rounded values the port uses."""
    import jax.numpy as jnp

    worst = 0
    for roll in rolls:
        r = np.float32(roll) * np.float32(np.pi / 180.0)
        for f64, fj, x in ((np.tan, jnp.tan, np.float32(r - np.float32(np.pi / 2.0))),
                           (np.sin, jnp.sin, r), (np.cos, jnp.cos, r)):
            a = np.float32(f64(np.float64(x)))
            b = np.float32(fj(jnp.float32(x)))
            worst = max(worst, abs(int(a.view(np.int32)) - int(b.view(np.int32))))
    return worst


def test_pushbroom_ray_matches_scalar_oracle():
    """The port's rays against the scalar oracle of tests/test_pushbroom.py
    at its tolerances, and against the JAX package's rays within caveat m's
    tolerance (the transcendentals within PNT_ULPS ulps)."""
    from ssrlcv_tpu.geometry.bundles import generate_pushbroom_bundles as jax_rays
    from ssrlcv_tpu_torch.core.types import MatchSet, PushbroomCameras
    from ssrlcv_tpu_torch.geometry.bundles import generate_pushbroom_bundles

    size = (2048, 1024)
    foc, radius, altitude, gsd = 0.012, 3396.19, 300.0, 0.25 / 1000.0
    pbs = _pushbrooms([12.0, -7.5], size=size, foc=foc, radius=radius, altitude=altitude,
                      gsd=gsd)
    dpix_x = float(pbs.dpix[0, 0])
    locs0 = np.array([[1024.0, 512.0], [100.0, 40.0], [2000.0, 1000.0]], np.float32)
    locs1 = np.array([[1024.0, 512.0], [300.0, 90.0], [1500.0, 700.0]], np.float32)
    ms = _matchset(locs0, locs1)
    bd = generate_pushbroom_bundles(_port(MatchSet, ms), _port(PushbroomCameras, pbs))
    vec, pnt = bd.vec.numpy(), bd.pnt.numpy()
    for i in range(3):
        for v, (loc, roll) in enumerate([(locs0[i], 12.0), (locs1[i], -7.5)]):
            ev, ep = _scalar_reference_ray(loc, size, dpix_x, foc, roll, radius, altitude, gsd)
            np.testing.assert_allclose(vec[i, v], ev, rtol=2e-4, atol=2e-6)
            np.testing.assert_allclose(pnt[i, v], ep, rtol=2e-4, atol=1e-3)

    # many rows at the rolls of the smoke run and of the tests
    rng = np.random.default_rng(0)
    for rolls in ([12.0, -7.5], [88.0, 92.0], [60.0, 120.0]):
        pbs = _pushbrooms(rolls)
        ms = _matchset(rng.uniform(0, size, (400, 2)).astype(np.float32),
                       rng.uniform(0, size, (400, 2)).astype(np.float32))
        jb = jax_rays(ms, pbs)
        tb = generate_pushbroom_bundles(_port(MatchSet, ms), _port(PushbroomCameras, pbs))
        m = np.asarray(ms.mask)
        jv, jp = np.asarray(jb.vec)[m], np.asarray(jb.pnt)[m]
        tv, tp = tb.vec.numpy()[m], tb.pnt.numpy()[m]
        assert _transcendental_ulps(rolls) <= PNT_ULPS
        assert np.abs(tp - jp).max() <= PNT_ULPS * _ulp(jp)
        assert np.abs(tv - jv).max() <= _ray_tol(jp, pbs)
        np.testing.assert_allclose(np.linalg.norm(tv, axis=-1), 1.0, rtol=1e-6)


def test_pushbroom_nadir_geometry():
    """roll = 90 deg: the craft sits on the x axis at the slant radius
    sqrt((h + r)^2 - r^2), and the ray is a unit vector."""
    from ssrlcv_tpu_torch.core.types import MatchSet, PushbroomCameras
    from ssrlcv_tpu_torch.geometry.bundles import generate_pushbroom_bundles

    radius, altitude = 3396.19, 300.0
    pbs = _pushbrooms([90.0, 90.0], radius=radius, altitude=altitude)
    ms = _matchset(np.array([[1024.0, 512.0]]), np.array([[1024.0, 512.0]]))
    bd = generate_pushbroom_bundles(_port(MatchSet, ms), _port(PushbroomCameras, pbs))
    pnt = bd.pnt.numpy()[0, 0]
    np.testing.assert_allclose(pnt[0], np.sqrt((altitude + radius) ** 2 - radius ** 2), rtol=1e-5)
    np.testing.assert_allclose(pnt[1], 0.0, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(bd.vec.numpy()[0, 0]), 1.0, rtol=1e-6)


def test_pushbroom_two_view_triangulates():
    """Two scans at rolls 60 and 120 deg through the port's generate_bundles
    dispatch (no pinhole cameras): the rays lie in the y = 0 plane and
    meet; the point equals the scalar oracle's crossing within 0.05 km (the
    JAX test's bound) and the JAX package's point within caveat m's bound."""
    from ssrlcv_tpu.geometry.bundles import generate_bundles as jax_bundles
    from ssrlcv_tpu.geometry.triangulation import two_view_triangulate as jax_tri
    from ssrlcv_tpu_torch.core.types import MatchSet, PushbroomCameras
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import two_view_triangulate

    pbs = _pushbrooms([60.0, 120.0])
    ms = _matchset(np.array([[1024.0, 512.0]] * 2), np.array([[1024.0, 512.0]] * 2))
    bd = generate_bundles(_port(MatchSet, ms), cameras=None,
                          pushbrooms=_port(PushbroomCameras, pbs))
    pc, err = two_view_triangulate(bd)
    pts = pc.points.numpy()[pc.mask.numpy()]
    assert np.all(np.isfinite(pts)) and float(err) < 1e-4
    dpix_x = float(pbs.dpix[0, 0])
    v0, p0 = _scalar_reference_ray([1024.0, 512.0], (2048, 1024), dpix_x, 0.012, 60.0, 3396.19,
                                   300.0, 0.25 / 1000.0)
    v1, p1 = _scalar_reference_ray([1024.0, 512.0], (2048, 1024), dpix_x, 0.012, 120.0, 3396.19,
                                   300.0, 0.25 / 1000.0)
    A = np.array([[v0[0], -v1[0]], [v0[2], -v1[2]]], np.float64)
    s, _ = np.linalg.solve(A, np.array([p1[0] - p0[0], p1[2] - p0[2]], np.float64))
    np.testing.assert_allclose(pts[0], p0 + s * v0, atol=0.05)

    jpc, _ = jax_tri(jax_bundles(ms, cameras=None, pushbrooms=pbs))
    jp = np.asarray(jpc.points)[np.asarray(jpc.mask)]
    tol = _point_tol(pts, bd.vec.numpy()[pc.mask.numpy()], bd.pnt.numpy()[pc.mask.numpy()])
    assert (np.linalg.norm(pts - jp, axis=1) <= tol).all()


def test_pushbroom_params_csv(tmp_path):
    """A pushbroom row and a pinhole row parse to the JAX package's values
    (gsd m -> km, fov deg -> rad, dpix.y 0)."""
    from ssrlcv_tpu.io.images import load_params_csv as jax_load
    from ssrlcv_tpu_torch.io.images import load_params_csv

    p = tmp_path / "params.csv"
    p.write_text("img0.png,pushbroom,18.5,226.0,3396.19,12.0,300.0,0.012,0.25,1.14\n"
                 "img1.png,-2.0,1.0,400.0,0.1,0.2,0.3,0.199,0.199,0.16,4e-7,4e-7,123\n")
    d = load_params_csv(str(p), size=(2048, 1024))
    j = jax_load(str(p), size=(2048, 1024))
    pb = d["img0.png"]["pushbroom"]
    assert pb["gsd"] == pytest.approx(0.00025) and pb["dpix"][1] == 0.0
    assert pb["dpix"][0] == pytest.approx(0.012 * np.tan(pb["fov"] / 2) / 1024.0)
    assert "pushbroom" not in d["img1.png"] and d["img1.png"]["foc"] == pytest.approx(0.16)
    for key in pb:
        np.testing.assert_array_equal(pb[key], j["img0.png"]["pushbroom"][key], err_msg=key)
    for key in ("cam_pos", "cam_rot", "fov", "foc", "dpix", "timestamp"):
        np.testing.assert_array_equal(d["img1.png"][key], j["img1.png"][key], err_msg=key)


@pytest.fixture(scope="module")
def pushbroom_dir(tmp_path_factory):
    """The seeded 256x256 pair and its seed image as a directory whose
    params.csv holds pushbroom rows (rolls 88 and 92 deg)."""
    from ssrlcv_tpu_torch.synthetic import make_scene, write_pushbroom_scene_dir

    root = tmp_path_factory.mktemp("pushbroom")
    seed = write_pushbroom_scene_dir(make_scene(seed=0, size=256), str(root / "images"))
    return root, str(root / "images"), seed


def test_pushbrooms_from_refimages(pushbroom_dir):
    """Both loaders read the directory to pushbroom images, and both stack
    them into the same PushbroomCameras (every field exact)."""
    from ssrlcv_tpu.io.images import load_directory as jax_dir
    from ssrlcv_tpu.io.images import pushbrooms_from_refimages as jax_stack
    from ssrlcv_tpu_torch.io.images import load_directory, pushbrooms_from_refimages

    _, d, _ = pushbroom_dir
    ti, ji = load_directory(d), jax_dir(d)
    assert [im.is_pushbroom for im in ti] == [im.is_pushbroom for im in ji] == [True, True]
    tp, jp = pushbrooms_from_refimages(ti, "cpu"), jax_stack(ji)
    for f in dataclasses.fields(tp):
        got = getattr(tp, f.name)
        assert got.device.type == "cpu"
        want = np.asarray(getattr(jp, f.name))
        assert got.numpy().dtype == want.dtype, f.name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
    np.testing.assert_array_equal(tp.roll.numpy(), [88.0, 92.0])
    np.testing.assert_array_equal(tp.size.numpy(), [[256, 256], [256, 256]])


def test_image0_dispatch(pushbroom_dir):
    """Only image 0 decides: image 1 alone pushbroom stacks no pushbroom
    cameras in either package, and the port's stage 0 then leaves
    ``state.pushbrooms`` None (the pinhole path); image 0 pushbroom does."""
    from ssrlcv_tpu.io.images import pushbrooms_from_refimages as jax_stack
    from ssrlcv_tpu_torch.config import PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.io.images import load_directory, pushbrooms_from_refimages
    from ssrlcv_tpu_torch.pipeline import stages as S
    from ssrlcv_tpu_torch.synthetic import make_scene

    _, d, _ = pushbroom_dir
    pb = load_directory(d)
    pin = make_scene(seed=1, size=64).images
    mixed = [dataclasses.replace(pin[0]), dataclasses.replace(pb[1])]
    assert pushbrooms_from_refimages(mixed, "cpu") is None and jax_stack(mixed) is None
    cfg = PipelineConfig().replace(sift=SIFTParams(max_keypoints=256))
    st = S.do_feature_generation(S.PipelineState(config=cfg, images=mixed, device="cpu"))
    assert st.pushbrooms is None and st.cameras.foc.numpy()[0] == pytest.approx(0.8593)
    st = S.do_feature_generation(S.PipelineState(config=cfg, images=pb, device="cpu"))
    assert st.pushbrooms is not None and st.pushbrooms.roll.tolist() == [88.0, 92.0]


def _brute_config(out_dir):
    from ssrlcv_tpu.config import MatchParams, PipelineConfig, SIFTParams

    return PipelineConfig(output_dir=str(out_dir)).replace(
        match=MatchParams(mode="brute", epsilon=25.0, delta=5.0),
        sift=SIFTParams(max_keypoints=4096))


def test_pushbroom_pipeline_matches_jax(pushbroom_dir):
    """The pair through both pipelines with mode "brute" and seed features
    (ROADMAP.md caveats j-l: the pinhole fields are zero, so only brute
    matching finds matches, and stage 5 adjusts zero pinhole cameras).
    Stage 0 runs in both; the port's stages 2-5 then take the JAX package's
    features, so both match identical descriptors: the same matches, the
    same pushbroom cameras, the stage-3 cloud's mask equal, the stage-4
    filter's within 2 %, the points of tracks both keep within
    ``_point_tol``, and BA errors NaN in both."""
    from ssrlcv_tpu.features.sift import generate_features as jax_sift
    from ssrlcv_tpu.io.images import load_directory as jax_dir
    from ssrlcv_tpu.pipeline import stages as J
    from ssrlcv_tpu_torch.core.types import FeatureSet
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.io.images import load_directory, load_image_with_params
    from ssrlcv_tpu_torch.pipeline import stages as T

    root, d, seed = pushbroom_dir
    seed_px = load_image_with_params(seed, -1, no_params=True).pixels
    js = J.PipelineState(config=_brute_config(root / "jax"), images=jax_dir(d))
    js.seed_features = jax_sift(seed_px, js.config.sift, image_id=-1)
    ts = T.PipelineState(config=_brute_config(root / "torch"), images=load_directory(d),
                         device="cpu",
                         seed_features=generate_features(seed_px, js.config.sift, -1,
                                                         device="cpu"))
    js, ts = J.do_feature_generation(js), T.do_feature_generation(ts)
    for tf, jf in zip(ts.features, js.features):
        nj = int(np.asarray(jf.mask).sum())
        assert nj > 1000 and abs(tf.count() - nj) <= 0.005 * nj
    for f in dataclasses.fields(ts.pushbrooms):
        np.testing.assert_array_equal(getattr(ts.pushbrooms, f.name).numpy(),
                                      np.asarray(getattr(js.pushbrooms, f.name)))
    ts.features = [_port(FeatureSet, f) for f in js.features]
    ts.seed_features = _port(FeatureSet, js.seed_features)

    js, ts = J.do_feature_matching(js), T.do_feature_matching(ts)
    tm, jm = ts.matches.mask.numpy(), np.asarray(js.matches.mask)
    assert tm.sum() > 100
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts.matches.kp_loc.numpy()[tm], np.asarray(js.matches.kp_loc)[jm])

    for name, jfn, tfn in (("triangulation", J.do_triangulation, T.do_triangulation),
                           ("filtering", J.do_filtering, T.do_filtering)):
        js, ts = jfn(js), tfn(ts)
        tm, jm = ts.cloud.mask.numpy(), np.asarray(js.cloud.mask)
        if name == "triangulation":
            np.testing.assert_array_equal(tm, jm)
        else:
            assert abs(int(tm.sum()) - int(jm.sum())) <= 0.02 * jm.sum()
            assert (tm & jm).sum() >= 0.97 * jm.sum()
        both = tm & jm
        tp, jp = ts.cloud.points.numpy()[both], np.asarray(js.cloud.points)[both]
        assert np.isfinite(tp).all(), name
        bd = generate_bundles(ts.matches, None, pushbrooms=ts.pushbrooms)
        tol = _point_tol(tp, bd.vec.numpy()[both], bd.pnt.numpy()[both])
        assert (np.linalg.norm(tp - jp, axis=1) <= tol).all(), name
    js, ts = J.do_bundle_adjust(js), T.do_bundle_adjust(ts)
    assert np.isnan(ts.ba_error).all() and np.isnan(js.ba_error).all()


def test_pushbroom_cli_matches_jax(pushbroom_dir, monkeypatch):
    """Both command lines on the pushbroom directory (mode "double", as
    the command line always matches): the epipolar gate of two all-zero
    pinhole cameras admits nothing, so both find 0 matches (caveat j) and
    write empty clouds."""
    from ssrlcv_tpu.config import PipelineConfig as JConfig
    from ssrlcv_tpu.config import SIFTParams as JSIFT
    from ssrlcv_tpu.logging import logger as jax_logger
    from ssrlcv_tpu.pipeline import sfm as J
    from ssrlcv_tpu_torch.config import PipelineConfig as TConfig
    from ssrlcv_tpu_torch.config import SIFTParams as TSIFT
    from ssrlcv_tpu_torch.io import ply
    from ssrlcv_tpu_torch.pipeline import sfm as T

    root, d, seed = pushbroom_dir
    monkeypatch.setattr(J, "PipelineConfig",
                        lambda **kw: JConfig(**kw).replace(sift=JSIFT(max_keypoints=4096)))
    monkeypatch.setattr(T, "PipelineConfig",
                        lambda **kw: TConfig(**kw).replace(sift=TSIFT(max_keypoints=4096)))
    for pkg, main, extra in (("torch", T.main, ["--device", "cpu"]), ("jax", J.main, [])):
        out = str(root / f"cli_{pkg}")
        jax_logger.close()  # the JAX stages above left their logger open elsewhere
        assert main(["-d", d, "-s", seed, "-o", out] + extra) == 0
        for name in ("ssrlcv-initial", "ssrlcv-filtered", "ssrlcv-BA-final"):
            assert len(ply.read_ply(os.path.join(out, f"{name}.ply"))["points"]) == 0, (pkg, name)
        with open(os.path.join(out, "ssrlcv.log")) as f:
            assert "total matches: 0" in f.read(), pkg
