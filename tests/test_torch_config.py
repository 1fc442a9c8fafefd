"""The port's own configuration, PLY and fixture modules against the JAX
package's, and its entry points' default device, on the CPU.

``ssrlcv_tpu_torch`` keeps copies of ``ssrlcv_tpu.config``, ``io.ply``,
``io.refdata``, ``io.csvio``, ``io.anatomy``, ``mesh.mc_tables`` and
``mesh.hierarchy``, so that it imports nothing of the JAX package; these
tests hold the copies to the originals (the PLY writers' files in
tests/test_torch_cloud_io.py).  Without a device named, the entry points take ``cuda:0`` and
raise where there is no card; the tests decide that with a monkeypatched
``torch.cuda.is_available``, inside each test.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest
import torch

_CONFIGS = ["SIFTParams", "MatchParams", "FilterParams", "BAParams", "PoseParams",
            "PipelineConfig"]


@pytest.mark.parametrize("name", _CONFIGS)
def test_config_copy_matches_jax(name):
    """Every field and default of each configuration class, and the Earth
    radii, equal the JAX package's."""
    from ssrlcv_tpu import config as J
    from ssrlcv_tpu_torch import config as T

    jc, tc = getattr(J, name), getattr(T, name)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())
    assert (T.EARTH_MAX_KM_FROM_CENT, T.EARTH_MIN_KM_FROM_CENT) == (
        J.EARTH_MAX_KM_FROM_CENT, J.EARTH_MIN_KM_FROM_CENT)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_copy_round_trips_with_jax(tmp_path, binary):
    """A cloud written by the port's writer reads back, through the port's
    reader and the JAX one, to the values the JAX writer's file gives; the
    port reads the JAX writer's file too."""
    from ssrlcv_tpu.io import ply as J
    from ssrlcv_tpu_torch.io import ply as T

    pts = np.random.default_rng(0).normal(0, 1000, (257, 3)).astype(np.float32)
    tp = T.write_ply(str(tmp_path / "port"), pts, binary=binary)
    jp = J.write_ply(str(tmp_path / "jax"), pts, binary=binary)
    assert tp.endswith("port.ply") and os.path.exists(tp)
    ref = J.read_ply(jp)["points"]
    for got in (T.read_ply(tp)["points"], J.read_ply(tp)["points"], T.read_ply(jp)["points"]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    if binary:
        np.testing.assert_array_equal(ref, pts)
    empty = T.write_ply(str(tmp_path / "empty"), np.zeros((0, 3)), binary=binary)
    assert T.read_ply(empty)["points"].shape == J.read_ply(empty)["points"].shape == (0, 3)


# modules the port copies from the JAX package (numpy only), and the
# functions whose code differs on purpose
_COPIES = {"io.csvio": (), "io.anatomy": (), "mesh.mc_tables": (),
           "mesh.hierarchy": ("knn_neighborhood",)}


@pytest.mark.parametrize("name", sorted(_COPIES))
def test_numpy_module_copies_match_jax(name):
    """Every function and class of each copied module has the JAX module's
    code (the search of hierarchy.knn_neighborhood, in torch, aside), and
    every module-level array equals the original's."""
    import importlib
    import inspect

    jm = importlib.import_module(f"ssrlcv_tpu.{name}")
    tm = importlib.import_module(f"ssrlcv_tpu_torch.{name}")
    for attr, obj in vars(jm).items():
        if attr.startswith("__") or inspect.ismodule(obj):
            continue
        assert hasattr(tm, attr), attr
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and obj.__module__ == jm.__name__:
            if attr not in _COPIES[name]:
                assert inspect.getsource(getattr(tm, attr)) == inspect.getsource(obj), attr
        elif isinstance(obj, np.ndarray):
            got = getattr(tm, attr)
            assert got.dtype == obj.dtype, attr
            np.testing.assert_array_equal(got, obj, err_msg=attr)


def _uty(path, name, array):
    a = np.ascontiguousarray(array)
    with open(path, "wb") as f:
        f.write(name.encode() + b"\n" + struct.pack("<Q", 1234) + b"\n"
                + struct.pack("<iQ", 1, len(a)) + b"\n" + a.tobytes())


def _write_fixture(d, rng):
    """A two-image fixture directory in the reference's formats."""
    from ssrlcv_tpu.io import refdata as R

    os.makedirs(d / "pixels")
    for i in range(2):
        raw = bytearray(240)
        struct.pack_into("<i", raw, 32, i)
        struct.pack_into("<III", raw, 40, 24, 16, 1)
        struct.pack_into("<3f3f2ff", raw, 56, *rng.normal(size=9))
        struct.pack_into("<2f", raw, 96, 1e-4, 1e-4)
        struct.pack_into("<q", raw, 104, 1_600_000_000 + i)
        struct.pack_into("<3f", raw, 112, *rng.normal(size=3))
        raw[208] = i
        (d / f"{i}_N6ssrlcv5ImageE.cpimg").write_bytes(bytes(raw))
        _uty(d / "pixels" / f"{i}_h.uty", "h", rng.integers(0, 256, 16 * 24).astype(np.uint8))
        kp = np.zeros(5, R.KEYPOINT_DT)
        kp["parentId"], kp["loc"] = i, rng.uniform(0, 24, (5, 2))
        _uty(d / f"{i}_N6ssrlcv8KeyPointE.uty", "KeyPoint", kp)
        mm = np.zeros(3, R.MULTIMATCH_DT)
        mm["numKeyPoints"], mm["index"] = 2, [0, 2, 4]
        _uty(d / f"{i}_N6ssrlcv10MultiMatchE.uty", "MultiMatch", mm)
    feat = np.zeros(7, R.FEATURE_SIFT_DT)
    feat["parent"], feat["loc"] = -1, rng.uniform(0, 24, (7, 2))
    feat["sigma"], feat["theta"] = rng.uniform(1, 2, 7), rng.uniform(0, 6, 7)
    feat["values"] = rng.integers(0, 256, (7, 128))
    _uty(d / "-1_N6ssrlcv7FeatureINS_15SIFT_DescriptorEEE.uty", "Feature", feat)
    for i in (0, 1):  # points2 absent, as in a fixture without BA output
        _uty(d / f"{i}_6float3.uty", "float3", rng.normal(size=(6, 3)).astype(np.float32))


def test_refdata_copy_matches_jax(tmp_path):
    """The port's fixture loader parses a small fixture directory (camera
    dumps, pixels, seed features, keypoints, multimatches, clouds) exactly
    as the JAX loader does."""
    from ssrlcv_tpu.io import refdata as J
    from ssrlcv_tpu_torch.io import refdata as T

    _write_fixture(tmp_path, np.random.default_rng(2))
    jf, tf = J.load_fixture_dir(str(tmp_path)), T.load_fixture_dir(str(tmp_path))
    assert jf.keys() == tf.keys() and "points2" not in tf
    for ji, ti in zip(jf["images"], tf["images"]):
        assert isinstance(ti, T.RefImage)
        for f in dataclasses.fields(J.RefImage):
            a, b = getattr(ji, f.name), getattr(ti, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
    assert tf["images"][1].is_pushbroom and tf["images"][0].pixels.shape == (16, 24)
    for key in ("keypoints0", "keypoints1", "multimatches0", "multimatches1"):
        for a, b in zip(jf[key], tf[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for k, a in jf["seed_features"].items():
        np.testing.assert_array_equal(a, tf["seed_features"][k], err_msg=k)
    for key in ("points0", "points1"):
        np.testing.assert_array_equal(jf[key], tf[key])


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device named the entry points want cuda:0: without a card
    each raises and names device='cpu'; with one, the state's device is
    cuda:0.  Naming the CPU works either way."""
    from ssrlcv_tpu_torch.config import PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.core.device import resolve_device
    from ssrlcv_tpu_torch.features.sift import generate_features, generate_features_many
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.pipeline import stages as S
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=1, size=64)
    px = scene.images[0].pixels
    sp = SIFTParams(max_keypoints=256)
    _no_card(monkeypatch)
    calls = {
        "PipelineState": lambda: S.PipelineState(config=PipelineConfig(), images=scene.images),
        "run_pipeline": lambda: S.run_pipeline(S.PipelineState(
            config=PipelineConfig(), images=scene.images, device="cpu"), "cuda"),
        "generate_features": lambda: generate_features(px, sp),
        "generate_features_many": lambda: generate_features_many([px, px], sp),
        "cameras_from_refimages": lambda: cameras_from_refimages(scene.images),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert S.PipelineState(config=PipelineConfig(), images=[], device="cpu").device.type == "cpu"
    assert cameras_from_refimages(scene.images, "cpu").cam_pos.device.type == "cpu"
    assert generate_features(px, sp, device="cpu").loc.device.type == "cpu"
    # a tensor's own device is used when none is named
    assert generate_features(torch.from_numpy(px), sp).loc.device.type == "cpu"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda:0")
    st = S.PipelineState(config=PipelineConfig(), images=scene.images)
    assert st.device == torch.device("cuda:0")
