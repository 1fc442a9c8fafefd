"""The port's command line, image / params.csv loading and checkpoints
against the JAX package, on the CPU.

``ssrlcv_tpu_torch.pipeline.sfm.main`` and ``ssrlcv_tpu.pipeline.sfm.main``
run on the same directories, written from the seeded 256x256 synthetic
scene: three views, and two views with ``--pose``.  Both command lines build
their config with the SIFT defaults; here both get ``max_keypoints`` 4096,
so the JAX package's chunked CPU matcher stays small.
"""

import dataclasses
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


# --- PNG -------------------------------------------------------------------

def _png_all_filters(px: np.ndarray) -> bytes:
    """A PNG of 8-bit pixels whose rows cycle through the five filter
    types (None, Sub, Up, Average, Paeth), encoded as the PNG specification
    defines them."""
    h, w = px.shape[:2]
    bpp = 1 if px.ndim == 2 else px.shape[2]
    rows = px.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    colour = 0 if px.ndim == 2 else 2
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3])
def test_png_matches_pil(tmp_path, channels):
    """PNG files written by PIL (adaptive filters) and a file using all five
    filter types decode as PIL decodes them; the port's own PNG files
    decode in PIL to the pixels written."""
    from PIL import Image

    from ssrlcv_tpu_torch.io.images import read_image, write_image

    rng = np.random.default_rng(channels)
    shape = (41, 67) if channels == 1 else (41, 67, 3)
    px = (np.cumsum(rng.integers(0, 9, shape), axis=1) % 256).astype(np.uint8)
    pil_path, ours, hand = (str(tmp_path / f"{n}.png") for n in ("pil", "ours", "hand"))
    Image.fromarray(px).save(pil_path, optimize=True)
    np.testing.assert_array_equal(read_image(pil_path), np.asarray(Image.open(pil_path)))
    with open(hand, "wb") as f:
        f.write(_png_all_filters(px))
    np.testing.assert_array_equal(np.asarray(Image.open(hand)), px)
    np.testing.assert_array_equal(read_image(hand), px)
    write_image(ours, px)
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), px)
    np.testing.assert_array_equal(read_image(ours), px)


# --- params.csv and directories ----------------------------------------------

def _fields(a, b):
    return {f.name for f in dataclasses.fields(a)} | {f.name for f in dataclasses.fields(b)}


def test_load_directory_matches_jax(tmp_path):
    """One written directory through both loaders: identical RefImage
    fields (pixels, float32 cameras after the ECEF offset) and identical
    Cameras; a pushbroom row and a malformed row parse and fail alike."""
    from ssrlcv_tpu.io import images as J
    from ssrlcv_tpu_torch.io import images as T
    from ssrlcv_tpu_torch.synthetic import make_scene, write_scene_dir

    d = str(tmp_path / "scene")
    write_scene_dir(make_scene(seed=2, size=64, n_views=3), d)
    ji, ti = J.load_directory(d), T.load_directory(d)
    assert len(ji) == len(ti) == 3
    for a, b in zip(ji, ti):
        for k in _fields(a, b):
            va, vb = getattr(a, k), getattr(b, k)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype, k
                np.testing.assert_array_equal(va, vb, err_msg=k)
            else:
                assert va == vb, k
    jc, tc = J.cameras_from_refimages(ji), T.cameras_from_refimages(ti, "cpu")
    for f in dataclasses.fields(tc):
        np.testing.assert_array_equal(getattr(tc, f.name).numpy(),
                                      np.asarray(getattr(jc, f.name)).astype(
                                          getattr(tc, f.name).numpy().dtype), err_msg=f.name)
    with open(os.path.join(d, "params.csv"), "a") as f:
        f.write("pb.png,pushbroom,10.5,20.25,3396.2,-3.5,280.0,12.0,0.3,1.15\n")
        f.write("broken.png,1.0,notanumber\n")
    jp = J.load_params_csv(os.path.join(d, "params.csv"), size=(64, 64))
    tp = T.load_params_csv(os.path.join(d, "params.csv"), size=(64, 64))
    assert jp.keys() == tp.keys() and "broken.png" not in tp
    for name in tp:
        for k, v in tp[name].items():
            w = jp[name][k]
            if isinstance(v, dict):
                assert v.keys() == w.keys()
                for kk in v:
                    np.testing.assert_array_equal(v[kk], w[kk])
            else:
                np.testing.assert_array_equal(v, w)


def test_checkpoint_stage_door(tmp_path):
    """The stage-door semantics of tests/test_io.py: markers, resume index,
    state and meta round trip; a shape mismatch raises ValueError."""
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.io import checkpoint as cp

    root = str(tmp_path / "ckpt")
    ms = MatchSet.empty(16, 2)
    ms.mask[0] = True
    assert cp.first_unfinished_stage(root, 6) == 0
    cp.save_stage(root, 0, "state", {"matches": ms}, meta={"n": 1})
    assert cp.is_stage_done(root, 0)
    assert cp.first_unfinished_stage(root, 6) == 1
    back = cp.load_stage(root, 0, "state", {"matches": MatchSet.empty(16, 2)})["matches"]
    assert bool(back.mask[0]) and not bool(back.mask[1])
    assert back.kp_loc.dtype == torch.float32 and back.kp_parent.dtype == torch.int32
    assert cp.load_stage_meta(root, 0) == {"n": 1}
    assert sorted(os.listdir(cp.stage_dir(root, 0))) == ["done", "meta.json", "state.npz"]
    with pytest.raises(ValueError):
        cp.load_stage(root, 0, "state", {"matches": MatchSet.empty(32, 2)})
    with pytest.raises(ValueError):
        cp.load_stage(root, 0, "state", {"other": MatchSet.empty(16, 2)})


# --- the command line ----------------------------------------------------------

@pytest.fixture(scope="module")
def scene3():
    from ssrlcv_tpu_torch.synthetic import make_scene

    return make_scene(seed=0, size=256, n_views=3)


def _small_config(**kw):
    from ssrlcv_tpu.config import PipelineConfig, SIFTParams

    return PipelineConfig(**kw).replace(sift=SIFTParams(max_keypoints=4096))


def _argv(d, seed, out, ckpt, pose):
    return (["-d", d, "-s", seed, "--epsilon", "25", "--delta", "5", "-cpdir", ckpt, "-o", out]
            + (["--pose"] if pose else []))


@pytest.fixture(scope="module")
def cli_runs(scene3, tmp_path_factory):
    """Both command lines on the 3-view directory and on the 2-view
    directory (images 0 and 1 of the same scene) with --pose."""
    from ssrlcv_tpu.logging import logger as jax_logger
    from ssrlcv_tpu.pipeline import sfm as J
    from ssrlcv_tpu_torch.pipeline import sfm as T
    from ssrlcv_tpu_torch.synthetic import write_scene_dir

    mp = pytest.MonkeyPatch()
    mp.setattr(J, "PipelineConfig", _small_config)
    mp.setattr(T, "PipelineConfig", _small_config)
    runs = {}
    try:
        for name, images, pose in (("three_views", scene3.images, False),
                                   ("two_views_pose", scene3.images[:2], True)):
            root = tmp_path_factory.mktemp(name)
            d = str(root / "images")
            seed = write_scene_dir(dataclasses.replace(scene3, images=images), d)
            for pkg, main, extra in (("torch", T.main, ["--device", "cpu"]), ("jax", J.main, [])):
                out, ck = str(root / f"{pkg}_out"), str(root / f"{pkg}_ckpt")
                # the JAX command line goes on writing to a log that JAX
                # code opened earlier in this process (the port's closes
                # it first): close it, so that its log lands in ``out``
                jax_logger.close()
                assert main(_argv(d, seed, out, ck, pose) + extra) == 0
            runs[name] = (root, d, seed, pose)
    finally:
        mp.undo()
    return runs


def _cloud(root, pkg, name):
    from ssrlcv_tpu.io import ply

    return ply.read_ply(os.path.join(root, f"{pkg}_out", f"{name}.ply"))["points"]


def _log(root, pkg="torch"):
    with open(os.path.join(root, f"{pkg}_out", "ssrlcv.log")) as f:
        return f.read()


def _ba_errors(line):
    """(initial, final) of a "bundle adjust: a -> b" row; the port's row
    goes on with the steps accepted in brackets."""
    return tuple(float(x) for x in line.split(":", 1)[1].split("(")[0].split("->"))


@pytest.mark.parametrize("case", ["three_views", "two_views_pose"])
def test_cli_matches_jax(cli_runs, scene3, case, monkeypatch):
    """Point counts of the three PLYs within 1 %; the initial and filtered
    clouds' median nearest-neighbour distance to JAX's within 1e-3 km for 2
    views and 5e-3 km for 3 views (N-view triangulation spreads by float32
    rounding, tests/test_torch_nview.py); the BA error per point within 5 %
    (test_torch_slice.py).  Then, with the stage-4 and stage-5 markers
    deleted, the port resumes at stage 4 and writes the same BA cloud."""
    from scipy.spatial import cKDTree

    from ssrlcv_tpu_torch.pipeline import sfm as T

    root, d, seed, pose = cli_runs[case]
    tol = 1e-3 if pose else 5e-3
    for name in ("ssrlcv-initial", "ssrlcv-filtered", "ssrlcv-BA-final"):
        t, j = _cloud(root, "torch", name), _cloud(root, "jax", name)
        assert len(t) > 200 and abs(len(t) - len(j)) <= 0.01 * len(j), name
        assert np.isfinite(t).all()
        if name != "ssrlcv-BA-final":
            assert np.median(cKDTree(j).query(t)[0]) <= tol, name
    assert np.median(scene3.surface_distance_m(_cloud(root, "torch", "ssrlcv-filtered"))) < 100.0

    log = _log(root)
    ba = [line for line in log.splitlines() if ",bundle adjust:" in line][-1]
    e0, e1 = _ba_errors(ba)
    jba = [line for line in _log(root, "jax").splitlines() if ",bundle adjust:" in line][-1]
    j0, j1 = _ba_errors(jba)
    assert e1 <= e0 and e0 == pytest.approx(j0, rel=5e-2) and e1 == pytest.approx(j1, rel=5e-2)
    stages = '"pose"' in [line for line in log.splitlines() if "stage seconds" in line][-1]
    assert stages == pose
    ck = os.path.join(root, "torch_ckpt")
    assert sorted(os.listdir(ck)) == [f"sfm-stage{i}" for i in range(6)]
    if pose:  # the pose stage moved camera 1 and kept camera 0
        c0 = np.load(os.path.join(ck, "sfm-stage0", "state.npz"))
        c1 = np.load(os.path.join(ck, "sfm-stage1", "state.npz"))
        assert not np.array_equal(c0["cameras.cam_rot"][1], c1["cameras.cam_rot"][1])
        np.testing.assert_array_equal(c0["cameras.cam_pos"][0], c1["cameras.cam_pos"][0])

    before = _cloud(root, "torch", "ssrlcv-BA-final")
    for stage in (4, 5):
        os.remove(os.path.join(ck, f"sfm-stage{stage}", "done"))
    os.remove(os.path.join(root, "torch_out", "ssrlcv-BA-final.ply"))
    monkeypatch.setattr(T, "PipelineConfig", _small_config)
    out = str(root / "torch_out")
    assert T.main(_argv(d, seed, out, ck, pose) + ["--device", "cpu"]) == 0
    log2 = _log(root)[len(log):]
    assert "resuming at stage 4" in log2 and "sift_seed" not in log2
    np.testing.assert_array_equal(_cloud(root, "torch", "ssrlcv-BA-final"), before)


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """--mesh auto on a directory with one image returns 1, as without the
    flag, and leaves no process group behind; --mesh 2x2 in one process
    raises, naming the world size; --device cuda without a card raises; a
    directory with one image returns 1.  Pushbroom cameras are dispatched on
    image 0 alone, as in the JAX package: a set whose image 1 alone is
    pushbroom runs the pinhole path, to the same cloud as without the
    flag."""
    from ssrlcv_tpu.io.images import pushbrooms_from_refimages as jax_stack
    from ssrlcv_tpu_torch.config import PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.pipeline import sfm as T
    from ssrlcv_tpu_torch.pipeline import stages as S
    from ssrlcv_tpu_torch.synthetic import make_scene, write_scene_dir

    scene = make_scene(seed=1, size=64)
    d, two = str(tmp_path / "one"), str(tmp_path / "two")
    write_scene_dir(dataclasses.replace(scene, images=scene.images[:1]), d)
    write_scene_dir(scene, two)
    out = str(tmp_path / "mesh_out")
    assert T.main(["-d", d, "-o", out, "--mesh", "auto", "--device", "cpu"]) == 1
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="world size 1"):
        T.main(["-d", two, "-o", out, "--mesh", "2x2", "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["-d", d])
    assert T.main(["-d", d, "-o", str(tmp_path / "out"), "--device", "cpu"]) == 1
    clouds = []
    for flag in (True, False):
        images = [dataclasses.replace(im) for im in scene.images]
        images[1].is_pushbroom = flag
        cfg = PipelineConfig(output_dir=str(tmp_path / f"pb{flag}")).replace(
            sift=SIFTParams(max_keypoints=512))
        st = S.run_pipeline(S.PipelineState(config=cfg, images=images, device="cpu"))
        assert st.pushbrooms is None
        assert flag is False or jax_stack(images) is None
        clouds.append(st.cloud)
    assert torch.equal(clouds[0].mask, clouds[1].mask)
    assert torch.equal(clouds[0].points, clouds[1].points)


def test_cli_mesh_matches_jax(scene3, tmp_path, monkeypatch):
    """Both command lines with --mesh 1x1 on a 2-view directory (the port
    starts a one-rank gloo group of its own): the distributed stages'
    clouds agree as test_cli_matches_jax's do (point counts within 1 %, the
    initial and filtered clouds' median nearest-neighbour distance within
    1e-3 km, the BA error within 5 %), and the port's clouds equal its own
    run without --mesh."""
    from scipy.spatial import cKDTree

    from ssrlcv_tpu.logging import logger as jax_logger
    from ssrlcv_tpu.pipeline import sfm as J
    from ssrlcv_tpu_torch.pipeline import sfm as T
    from ssrlcv_tpu_torch.synthetic import write_scene_dir

    monkeypatch.setattr(J, "PipelineConfig", _small_config)
    monkeypatch.setattr(T, "PipelineConfig", _small_config)
    d = str(tmp_path / "images")
    seed = write_scene_dir(dataclasses.replace(scene3, images=scene3.images[:2]), d)
    runs = (("torch", T.main, ["--mesh", "1x1", "--device", "cpu"]),
            ("jax", J.main, ["--mesh", "1x1"]),
            ("torch_single", T.main, ["--device", "cpu"]))
    for pkg, main, extra in runs:
        jax_logger.close()
        assert main(_argv(d, seed, str(tmp_path / f"{pkg}_out"), str(tmp_path / f"{pkg}_ckpt"),
                          False) + extra) == 0
    assert not torch.distributed.is_initialized()
    assert "distributed stages over mesh {'data': 1, 'feat': 1}" in _log(tmp_path)
    for name in ("ssrlcv-initial", "ssrlcv-filtered", "ssrlcv-BA-final"):
        t, j = _cloud(tmp_path, "torch", name), _cloud(tmp_path, "jax", name)
        assert len(t) > 200 and abs(len(t) - len(j)) <= 0.01 * len(j), name
        if name != "ssrlcv-BA-final":
            assert np.median(cKDTree(j).query(t)[0]) <= 1e-3, name
        np.testing.assert_allclose(t, _cloud(tmp_path, "torch_single", name), rtol=2e-6,
                                   atol=1e-4, err_msg=name)
    e = [_ba_errors(line) for pkg in ("torch", "jax") for line in _log(tmp_path, pkg).splitlines()
         if ",bundle adjust:" in line]
    assert e[0][1] <= e[0][0] and e[0][1] == pytest.approx(e[1][1], rel=5e-2)


def test_resume_without_match_capacity(cli_runs, monkeypatch):
    """A stage-2 checkpoint whose meta.json lacks match_capacity (as written
    before that key was recorded): the port's _restore reads the capacity
    from the first 3-D array of state.npz, as the JAX package does, and
    restores the same MatchSet as with the key; both command lines then
    resume at stage 3 and finish, the port with the BA cloud it wrote
    before."""
    import json

    from ssrlcv_tpu.logging import logger as jax_logger
    from ssrlcv_tpu.pipeline import sfm as J
    from ssrlcv_tpu_torch.io.images import load_directory
    from ssrlcv_tpu_torch.pipeline import sfm as T
    from ssrlcv_tpu_torch.pipeline import stages as S

    root, d, seed, pose = cli_runs["three_views"]
    before = _cloud(root, "torch", "ssrlcv-BA-final")
    monkeypatch.setattr(J, "PipelineConfig", _small_config)
    monkeypatch.setattr(T, "PipelineConfig", _small_config)
    for pkg, main, extra in (("torch", T.main, ["--device", "cpu"]), ("jax", J.main, [])):
        ck, out = str(root / f"{pkg}_ckpt"), str(root / f"{pkg}_out")
        meta_path = os.path.join(ck, "sfm-stage2", "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        saved = meta.pop("match_capacity")
        if pkg == "torch":
            restored = {}
            for m in (dict(meta, match_capacity=saved), meta):
                with open(meta_path, "w") as f:
                    json.dump(m, f)
                st = S.PipelineState(config=_small_config(), images=load_directory(d),
                                     device="cpu")
                S._restore(st, ck, 3)
                restored[len(m)] = st.matches
            with_key, probed = restored.values()
            assert probed.capacity == saved == with_key.capacity
            for k in ("kp_loc", "kp_parent", "num_views", "mask"):
                assert torch.equal(getattr(probed, k), getattr(with_key, k)), k
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        for stage in (3, 4, 5):
            os.remove(os.path.join(ck, f"sfm-stage{stage}", "done"))
        os.remove(os.path.join(out, "ssrlcv-BA-final.ply"))
        start = len(_log(root, pkg))
        jax_logger.close()
        assert main(_argv(d, seed, out, ck, pose) + extra) == 0
        assert "resuming at stage 3" in _log(root, pkg)[start:]
        with np.load(os.path.join(ck, "sfm-stage3", "state.npz")) as z:
            shapes = [z[k].shape[0] for k in z.files if z[k].ndim == 3]
        assert shapes[0] == saved
    np.testing.assert_array_equal(_cloud(root, "torch", "ssrlcv-BA-final"), before)
    t, j = _cloud(root, "torch", "ssrlcv-BA-final"), _cloud(root, "jax", "ssrlcv-BA-final")
    assert abs(len(t) - len(j)) <= 0.01 * len(j)
