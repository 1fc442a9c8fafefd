"""The port's 2-view slice end to end against the JAX package, on the CPU.

A seeded synthetic 256x256 pair (ssrlcv_tpu_torch.synthetic) goes through
ssrlcv_tpu_torch.pipeline.stages and through ssrlcv_tpu.pipeline.stages:
feature counts agree within 0.5 %, points after filtering within 1 %, and
the clouds of the tracks both keep within 1e-3 km (median).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    from ssrlcv_tpu_torch.synthetic import make_scene

    return make_scene(seed=0, size=256)


def _config(out_dir, mode="double"):
    from ssrlcv_tpu.config import MatchParams, PipelineConfig, SIFTParams

    # the main path's matcher settings; a small capacity keeps the JAX
    # chunked matcher small on the CPU
    return PipelineConfig(output_dir=str(out_dir)).replace(
        match=MatchParams(epsilon=25.0, delta=5.0, mode=mode),
        sift=SIFTParams(max_keypoints=4096))


@pytest.mark.parametrize("mode", ["double", "brute"])
def test_slice_matches_jax(scene, tmp_path, mode):
    """Stage 2 in mode "double" (the main path) and "brute" (brute-force
    matching with seed distances)."""
    from ssrlcv_tpu.features.sift import generate_features as jax_sift
    from ssrlcv_tpu.pipeline import stages as J
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.pipeline import stages as T

    cfg = _config(tmp_path / "torch", mode)
    ts = T.PipelineState(config=cfg, images=scene.images,
                         seed_features=generate_features(scene.seed_image.pixels, cfg.sift, -1))
    ts = T.run_pipeline(ts, "cpu")

    js = J.PipelineState(config=cfg.replace(output_dir=str(tmp_path / "jax")),
                         images=scene.images)
    js.seed_features = jax_sift(scene.seed_image.pixels, cfg.sift, image_id=-1)
    for stage in (J.do_feature_generation, J.do_feature_matching, J.do_triangulation,
                  J.do_filtering, J.do_bundle_adjust):
        js = stage(js)

    for tf, jf in zip(ts.features, js.features):
        nj = int(np.asarray(jf.mask).sum())
        assert nj > 1000
        assert abs(tf.count() - nj) <= 0.005 * nj
    tm, jm = ts.matches.mask.numpy(), np.asarray(js.matches.mask)
    assert tm.sum() > 200
    assert abs(int(tm.sum()) - int(jm.sum())) <= 0.01 * jm.sum()

    # tracks kept by both, keyed by their image-0 keypoint: the filtered
    # clouds (triangulated with the input cameras, as the JAX benchmark's
    # cloud_vs_golden_m) within 1e-3 km.  Bundle adjustment then moves
    # camera 1 along directions the linear error barely constrains, so
    # BA-final clouds of two slightly different match sets are compared by
    # their error per point only.
    from ssrlcv_tpu.geometry.triangulation import triangulate_matches as jax_tri
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches

    tkey = {tuple(k): i for i, k in enumerate(np.round(ts.matches.kp_loc.numpy()[tm, 0], 3))}
    jloc = np.round(np.asarray(js.matches.kp_loc)[jm, 0], 3)
    pairs = [(tkey[tuple(k)], j) for j, k in enumerate(jloc) if tuple(k) in tkey]
    assert len(pairs) >= 0.99 * jm.sum()
    ti, ji = np.array(pairs).T
    tpc, _ = triangulate_matches(ts.matches, T.cameras_from_refimages(scene.images))
    jpc, _ = jax_tri(js.matches, cameras_from_refimages(scene.images))
    tp = tpc.points.numpy()[tm][ti]
    jp = np.asarray(jpc.points)[jm][ji]
    assert np.median(np.linalg.norm(tp - jp, axis=1)) <= 1e-3
    assert ts.ba_error[1] <= ts.ba_error[0]
    per_point = (ts.ba_error[1] / tm.sum(), js.ba_error[1] / jm.sum())
    assert per_point[0] == pytest.approx(per_point[1], rel=0.05)

    assert set(ts.stage_seconds) == {"features", "matching", "triangulation", "filtering",
                                     "bundle_adjust"}
    for name in ("ssrlcv-initial", "ssrlcv-filtered", "ssrlcv-BA-final"):
        assert os.path.exists(tmp_path / "torch" / f"{name}.ply")

    # the reconstruction lies on the scene's true surface (a 16 m ground
    # sample distance; 100 m is the smoke run's bound)
    assert np.median(scene.surface_distance_m(tpc.points.numpy()[tm])) < 100.0


def test_port_imports_no_jax():
    """Importing the package and every module of the slice leaves jax out
    of sys.modules (in a fresh interpreter)."""
    mods = ["ssrlcv_tpu_torch", "ssrlcv_tpu_torch.synthetic",
            "ssrlcv_tpu_torch.pipeline.stages", "ssrlcv_tpu_torch.features.sift",
            "ssrlcv_tpu_torch.matching.match", "ssrlcv_tpu_torch.geometry.filters",
            "ssrlcv_tpu_torch.ba.two_view", "ssrlcv_tpu_torch._cuda",
            "ssrlcv_tpu_torch.features.patches", "ssrlcv_tpu_torch.matching.match_mma",
            "ssrlcv_tpu_torch.bench.gather_patches", "ssrlcv_tpu_torch.bench.timing"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            + "assert not bad, bad\nprint('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _jax_values(name):
    """A small JAX value of each core type, made from numpy."""
    import jax.numpy as jnp

    from ssrlcv_tpu.core import types as J

    rng = np.random.default_rng(0)
    if name == "Cameras":
        return J.Cameras(cam_pos=jnp.asarray(rng.normal(size=(2, 3)), jnp.float32),
                         cam_rot=jnp.asarray(rng.normal(size=(2, 3)), jnp.float32),
                         fov=jnp.full((2, 2), 0.04, jnp.float32),
                         foc=jnp.full((2,), 0.86, jnp.float32),
                         dpix=jnp.full((2, 2), 7e-5, jnp.float32),
                         size=jnp.full((2, 2), 1024, jnp.int32),
                         ecef_offset=jnp.asarray(rng.normal(size=(2, 3)), jnp.float32),
                         timestamp=jnp.zeros((2,), jnp.int32))
    if name == "FeatureSet":
        fs = J.FeatureSet.empty(16, parent=3)
        return fs.replace(descriptors=jnp.asarray(rng.integers(0, 256, (16, 128)), jnp.uint8),
                          mask=jnp.arange(16) < 9)
    if name == "MatchSet":
        return J.MatchSet.empty(8)
    if name == "Bundles":
        return J.Bundles(vec=jnp.asarray(rng.normal(size=(4, 2, 3)), jnp.float32),
                         pnt=jnp.zeros((4, 2, 3), jnp.float32),
                         num_views=jnp.full((4,), 2, jnp.int32), mask=jnp.ones((4,), bool))
    return J.PointCloud(points=jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
                        errors=jnp.zeros((5,), jnp.float32), mask=jnp.ones((5,), bool))


@pytest.mark.parametrize("name", ["Cameras", "FeatureSet", "MatchSet", "Bundles", "PointCloud"])
def test_numpy_bridge_round_trips(name):
    """A JAX value fetched with np.asarray becomes the port's with the same
    field names, dtypes and values, and back."""
    from ssrlcv_tpu_torch.core import types as T

    jv = _jax_values(name)
    arrays = {f.name: np.asarray(getattr(jv, f.name)) for f in dataclasses.fields(jv)}
    tv = getattr(T, name).from_numpy(**arrays)
    back = tv.to_numpy()
    assert back.keys() == arrays.keys()
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype, k
        np.testing.assert_array_equal(back[k], a)
    with pytest.raises(ValueError):
        getattr(T, name).from_numpy(**{k: a for k, a in list(arrays.items())[1:]})
