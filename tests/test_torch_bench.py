"""The port's measurement drivers (``ssrlcv_tpu_torch.bench``, ``tester``)
and its Logger against the JAX package, on the CPU.

The drivers' inner functions run with ``device="cpu"`` on numpy-seeded
synthetic scenes (256^2 for the 2-view drivers, 128^2 for three views),
beside the same JAX calls in the JAX scripts' order, under the tolerances
of tests/test_torch_slice.py and ROADMAP.md section 3.  Their entry points
stop without a CUDA device.
"""

import contextlib
import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SIFT_CAP = 4096  # a small capacity keeps the JAX chunked matcher small on the CPU


def _port(value, cls):
    return cls.from_numpy(**{f.name: np.asarray(getattr(value, f.name))
                             for f in dataclasses.fields(value)})


def _jax(value, cls):
    return cls(**{f.name: jnp.asarray(getattr(value, f.name).numpy())
                  for f in dataclasses.fields(value)})


def _rows(path):
    """(tag, payload) of each row of a CSV log, the timestamps dropped."""
    with open(path) as f:
        return [tuple(line.rstrip("\n").split(",", 2)[1:]) for line in f]


def _drive_logger(logger, traced_phase):
    """The call sequence; ``traced_phase(logger)`` opens the phase "traced"
    on the package's profiler."""
    logger.info("one")
    logger.comment("a comment, with a comma\nand a newline")
    logger.log_state("start")
    logger.warn("two")
    logger.err("three")
    with logger.phase("plain"):
        pass
    with traced_phase(logger):
        pass
    logger.log_device_memory()
    logger.start_background_logging(0.02)
    deadline = time.time() + 10
    while ("comment", "heartbeat") not in _rows(logger.path) and time.time() < deadline:
        time.sleep(0.01)
    logger.stop_background_logging()
    n_beats = _rows(logger.path).count(("comment", "heartbeat"))
    logger.log_state("end")
    time.sleep(0.06)  # three periods: a heartbeat still running would write here
    logger.close()
    rows = _rows(logger.path)
    assert rows.count(("comment", "heartbeat")) == n_beats >= 1
    return [r for r in rows if r != ("comment", "heartbeat") and " took " not in r[1]], rows


@contextlib.contextmanager
def _profiled_phase(logger):
    """The port's phase "traced" under torch.profiler: a span, so the
    profiler's one range is "stage.traced"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with logger.phase("traced"):
            yield
    assert [e.name for e in prof.events() if e.is_user_annotation] == ["stage.traced"]


@pytest.mark.parametrize("level", ["info", "error"])
def test_logger_rows_match_jax(tmp_path, level):
    """One call sequence through both loggers: the same rows (tags and
    payloads) but for the timestamps, the heartbeats (at least one each,
    none after the stop) and the phases' host seconds; a phase traced on
    each package's profiler writes the rows of any other phase."""
    from ssrlcv_tpu.logging import Logger as JLogger
    from ssrlcv_tpu_torch.logging import Logger as TLogger

    want, jrows = _drive_logger(JLogger(str(tmp_path / "jax"), level=level),
                                lambda lg: lg.phase("traced", profile=True))
    got, trows = _drive_logger(TLogger(str(tmp_path / "torch"), level=level), _profiled_phase)
    assert got == want
    assert [t for t, _ in trows if t != "comment"] == [t for t, _ in jrows if t != "comment"]
    assert ("state", "traced:begin") in got and ("comment", "a comment, with a comma and a "
                                                 "newline") in got
    assert (("info", "one") in got) == (level == "info")


@pytest.fixture(scope="module")
def scene2():
    from ssrlcv_tpu_torch.synthetic import make_scene

    return make_scene(seed=0, size=256)


@pytest.fixture(scope="module")
def recon(scene2):
    """reconstruct.run_once on the CPU, and the same JAX calls in bench.py's
    order (run_once there), each package on its own SIFT."""
    from ssrlcv_tpu.ba.two_view import bundle_adjust_two_view
    from ssrlcv_tpu.config import MatchParams, SIFTParams as JSIFT
    from ssrlcv_tpu.features.sift import generate_features as jsift, generate_features_many
    from ssrlcv_tpu.geometry import filters as JF
    from ssrlcv_tpu.io.images import cameras_from_refimages as jcams
    from ssrlcv_tpu.matching import match as JM
    from ssrlcv_tpu_torch.bench.reconstruct import run_once
    from ssrlcv_tpu_torch.config import SIFTParams
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages

    sp = SIFTParams(max_keypoints=SIFT_CAP)
    cams = cameras_from_refimages(scene2.images, "cpu")
    seed = generate_features(scene2.seed_image.pixels, sp, -1, device="cpu")
    torch_out = run_once(scene2.images, cams, seed, sp, min_points=200)

    jsp = JSIFT(max_keypoints=SIFT_CAP)
    jc = jcams(scene2.images)
    jseed = jsift(scene2.seed_image.pixels, jsp, image_id=-1)
    f0, f1 = generate_features_many([im.pixels for im in scene2.images], jsp, image_ids=[0, 1])
    sd = JM.seed_distances(f0, jseed)
    dm = JM.match_double_constrained(f0, f1, jc, 0, 1, MatchParams(epsilon=25.0, delta=5.0),
                                     seed_dist=sd)
    ms = JM.matches_to_matchset(dm, f0, f1, 0, 1)
    ms = JF.linear_cutoff_filter(ms, jc, 100.0)
    ms = JF.deterministic_statistical_filter(ms, jc, 3.0, 10)
    r = bundle_adjust_two_view(ms, jc, iterations=10, mode="lm")
    return {"torch": torch_out, "cams": cams, "seed": seed,
            "jax": (int(np.asarray(ms.mask).sum()), float(r.final_error), (f0, f1, ms, r)),
            "jcams": jc}


def test_reconstruct_run_once_matches_jax(recon, scene2):
    """Features within 0.5 %, points within 1 %, the filtered clouds of the
    tracks both keep within 1e-3 km (median), BA down in both and its error
    per point within 5 % (test_torch_slice.py's tolerances)."""
    from ssrlcv_tpu.geometry.triangulation import triangulate_matches as jtri
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches

    n, err, (f0, f1, _, _, ms, r) = recon["torch"]
    jn, jerr, (jf0, jf1, jms, jr) = recon["jax"]
    for tf, jf in ((f0, jf0), (f1, jf1)):
        nj = int(np.asarray(jf.mask).sum())
        assert nj > 1000 and abs(tf.count() - nj) <= 0.005 * nj
    assert n > 200 and abs(n - jn) <= 0.01 * jn
    assert err == float(r.final_error) and err <= float(r.initial_error)
    assert jerr <= float(jr.initial_error)
    assert err / n == pytest.approx(jerr / jn, rel=0.05)

    tm, jm = ms.mask.numpy(), np.asarray(jms.mask)
    tkey = {tuple(k): i for i, k in enumerate(np.round(ms.kp_loc.numpy()[tm, 0], 3))}
    jloc = np.round(np.asarray(jms.kp_loc)[jm, 0], 3)
    pairs = [(tkey[tuple(k)], j) for j, k in enumerate(jloc) if tuple(k) in tkey]
    assert len(pairs) >= 0.99 * jm.sum()
    ti, ji = np.array(pairs).T
    tp = triangulate_matches(ms, recon["cams"])[0].points.numpy()[tm][ti]
    jp = np.asarray(jtri(jms, recon["jcams"])[0].points)[jm][ji]
    assert np.median(np.linalg.norm(tp - jp, axis=1)) <= 1e-3
    assert np.median(scene2.surface_distance_m(tp)) < 100.0


def test_tester_matches_jax(recon):
    """The tester's MatchSet (seed distances, double-constrained match) and
    its triangulation against JAX's generate_bundles + two_view_triangulate
    on the same features: the same match set, the same count, the total
    linear error within rtol 1e-3.  That error sums ~600 squared gaps of a
    few metres between rays whose points lie 400 km out, where a float32
    ulp is 3 cm: each track's gap rounds by ~1 % (median 0.5 % between the
    packages, whose rays differ by an ulp), so the sum by ~1e-3; measured
    2e-4."""
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.core.types import FeatureSet as JFS, MatchSet as JMS
    from ssrlcv_tpu.geometry.bundles import generate_bundles
    from ssrlcv_tpu.geometry.triangulation import two_view_triangulate
    from ssrlcv_tpu.matching import match as JM
    from ssrlcv_tpu_torch.tester import main_path_matchset, triangulate

    f0, f1 = recon["torch"][2][:2]
    ms = main_path_matchset(f0, f1, recon["seed"], recon["cams"])
    j0, j1, jseed = (_jax(f, JFS) for f in (f0, f1, recon["seed"]))
    dm = JM.match_double_constrained(j0, j1, recon["jcams"], 0, 1,
                                     MatchParams(epsilon=25.0, delta=5.0),
                                     seed_dist=JM.seed_distances(j0, jseed))
    jms = JM.matches_to_matchset(dm, j0, j1, 0, 1)
    for k in ("kp_loc", "kp_parent", "num_views", "mask"):
        np.testing.assert_array_equal(getattr(ms, k).numpy(), np.asarray(getattr(jms, k)), k)
    n, err = triangulate(ms, recon["cams"])
    _, jerr = two_view_triangulate(generate_bundles(_jax(ms, JMS), recon["jcams"]))
    assert n == int(np.asarray(jms.mask).sum()) > 200
    assert err == pytest.approx(float(jerr), rel=1e-3)


def test_pose_driver_matches_jax(recon):
    """The pose driver's steps on the same features as JAX's
    (bench_pose_tpu.py's order): the same pose match set, the refined pose
    within 1e-5 (tests/test_torch_pose.py), then the post-pose matches and
    points within 1 % and the linear error within 5 %, camera 1's shift
    within 10 m (1e-5 of the pose's position unit, 1000 km)."""
    from ssrlcv_tpu.config import MatchParams, PoseParams
    from ssrlcv_tpu.core.types import FeatureSet as JFS
    from ssrlcv_tpu.geometry.triangulation import triangulate_matches as jtri
    from ssrlcv_tpu.matching import match as JM
    from ssrlcv_tpu.pose.lm import apply_pose as japply, lm_optimize as jlm
    from ssrlcv_tpu_torch.bench.pose import pose_matches, post_pose
    from ssrlcv_tpu_torch.pose.lm import apply_pose, lm_optimize

    f0, f1, sd = recon["torch"][2][:3]
    cams, jc = recon["cams"], recon["jcams"]
    # the pose thresholds but the matcher's absolute one: at 256^2 no pair
    # lies within the pose stage's 10^2, and the LM would have nothing to do
    pp = PoseParams(absolute_threshold=200.0 ** 2)
    ms = pose_matches(f0, f1, cams, sd, pp)
    assert ms.count() > 200
    pose = lm_optimize(ms, cams, pp)
    post = post_pose(f0, f1, cams, apply_pose(cams, pose), sd)

    j0, j1 = _jax(f0, JFS), _jax(f1, JFS)
    jsd = jnp.asarray(sd.numpy())
    jmp = MatchParams(relative_threshold=pp.relative_threshold,
                      absolute_threshold=pp.absolute_threshold, epsilon=pp.epsilon,
                      delta=pp.delta)
    jms = JM.matches_to_matchset(JM.match_double_constrained(j0, j1, jc, 0, 1, jmp,
                                                             seed_dist=jsd), j0, j1, 0, 1)
    np.testing.assert_array_equal(ms.mask.numpy(), np.asarray(jms.mask))
    np.testing.assert_array_equal(ms.kp_loc.numpy(), np.asarray(jms.kp_loc))
    jpose = jlm(jms, jc, pp)
    np.testing.assert_allclose(pose.rot.numpy(), np.asarray(jpose.rot), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pose.pos.numpy(), np.asarray(jpose.pos), rtol=0, atol=1e-5)
    jnew = japply(jc, jpose)
    dm2 = JM.match_double_constrained(j0, j1, jnew, 0, 1, MatchParams(epsilon=25.0, delta=5.0),
                                      seed_dist=jsd)
    jms2 = JM.matches_to_matchset(dm2, j0, j1, 0, 1)
    jpc, jerr = jtri(jms2, jnew)
    jn = int(np.asarray(jms2.mask).sum())
    assert jn > 200 and abs(post["post_pose_matches"] - jn) <= 0.01 * jn
    jp = int(np.asarray(jpc.mask).sum())
    assert abs(post["post_pose_points"] - jp) <= 0.01 * jp
    assert post["post_pose_total_linear_error"] == pytest.approx(float(jerr), rel=0.05)
    shift = float(np.linalg.norm(np.asarray(jnew.cam_pos[1] - jc.cam_pos[1]))) * 1000.0
    assert post["cam1_pos_shift_m"] == pytest.approx(shift, abs=1e-2 * 1000.0)


def test_profile_sift_parts_equal_generate_features(recon, scene2):
    """profile_sift's parts, concatenated in order, are generate_features'
    rows: the same per-octave counts (each octave's features the run of
    rows it contributes) and the same keypoints and descriptors."""
    from ssrlcv_tpu_torch.bench.profile_sift import profile
    from ssrlcv_tpu_torch.config import SIFTParams

    f0 = recon["torch"][2][0]
    rec, parts = profile(scene2.images[0].pixels, SIFTParams(max_keypoints=SIFT_CAP), "cpu",
                         timed=False)
    per_octave = [o["features"] for o in rec["octaves"]]
    assert sum(per_octave) == f0.count() == rec["features"]
    assert len(per_octave) == 4 and per_octave[0] > 0
    assert all(o["features"] == sum(b["features"] for b in o["buckets"]) for o in rec["octaves"])
    assert all("detect_s" not in o for o in rec["octaves"])  # no times from the CPU
    loc, _, theta, desc = (torch.cat([p[i] for p in parts]) for i in range(4))
    n = f0.count()
    np.testing.assert_array_equal(loc.numpy(), f0.loc[:n].numpy())
    np.testing.assert_array_equal(theta.numpy(), f0.theta[:n].numpy())
    np.testing.assert_array_equal(desc.numpy(), f0.descriptors[:n].numpy())


def test_nview_driver_matches_jax():
    """bench_nview's stages on the same features (the port's SIFT of the
    128^2 three views): identical tracks; the triangulated cloud's mask
    equal and its points within 20 m median (N-view triangulation rounds
    differently: 0.8-1.4 m median on the 256^2 scene; the JAX golden
    test's 20 m); the filter's masks agreeing on >= 99 % of
    the tracks, its counts within 1 %; BA on the port's filtered tracks in
    both packages, down in both, initial and final errors within 5 %.  On
    SIFT tracks the N-view objective is float32 rounding: JAX's jitted BA
    objective and its eager n_view_triangulate total differ by 3.3 % on the
    same tracks and cameras (the port's total lies 0.14 % from the eager
    one), and single tracks' errors by up to 3e-6 km^2 of 1e-6 to 1e-5."""
    from ssrlcv_tpu.ba.nview import bundle_adjust_nview as jba
    from ssrlcv_tpu.config import BAParams, MatchParams
    from ssrlcv_tpu.core.types import FeatureSet as JFS, MatchSet as JMS
    from ssrlcv_tpu.geometry import filters as JF
    from ssrlcv_tpu.geometry.triangulation import triangulate_matches as jtri
    from ssrlcv_tpu.io.images import cameras_from_refimages as jcams
    from ssrlcv_tpu.matching.tracks import generate_matches_exhaustive as jgme
    from ssrlcv_tpu_torch.bench.nview import run
    from ssrlcv_tpu_torch.config import SIFTParams
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=0, size=128, n_views=3)
    sp = SIFTParams(max_keypoints=SIFT_CAP)
    seed = generate_features(scene.seed_image.pixels, sp, -1, device="cpu")
    feats, ms, pc, ms_f, pc_f, ba = run(scene.images, cameras_from_refimages(scene.images, "cpu"),
                                        seed, sp)
    jc = jcams(scene.images)
    jms = jgme([_jax(f, JFS) for f in feats], jc, MatchParams(epsilon=25.0, delta=5.0),
               seed_features=_jax(seed, JFS))
    for k in ("kp_loc", "kp_parent", "num_views", "mask"):
        np.testing.assert_array_equal(getattr(ms, k).numpy(), np.asarray(getattr(jms, k)), k)
    nv = ms.num_views.numpy()[ms.mask.numpy()]
    assert ms.count() > 100 and (nv == 3).sum() > 20
    jpc, _ = jtri(jms, jc, two_view=False)
    m = np.asarray(jpc.mask)
    np.testing.assert_array_equal(pc.mask.numpy(), m)
    d = np.linalg.norm(pc.points.numpy()[m] - np.asarray(jpc.points)[m], axis=1)
    assert np.median(d) <= 0.02
    jms_f = JF.deterministic_statistical_filter(jms, jc, 3.0, 10, two_view=False)
    jmask = np.asarray(jms_f.mask)
    assert (ms_f.mask.numpy() == jmask).mean() >= 0.99
    assert abs(ms_f.count() - int(jmask.sum())) <= 0.01 * jmask.sum()
    jpc_f, _ = jtri(jms_f, jc, two_view=False)
    both = pc_f.mask.numpy() & np.asarray(jpc_f.mask)
    d = np.linalg.norm(pc_f.points.numpy()[both] - np.asarray(jpc_f.points)[both], axis=1)
    assert np.median(d) <= 0.02
    # BA on the port's filtered tracks in both packages
    jr = jba(_jax(ms_f, JMS), jc, BAParams(iterations=5))
    assert float(ba.initial_error) == pytest.approx(float(jr.initial_error), rel=5e-2)
    assert float(ba.final_error) == pytest.approx(float(jr.final_error), rel=5e-2)
    assert float(ba.final_error) <= float(ba.initial_error)
    assert float(jr.final_error) <= float(jr.initial_error)


def test_match_kernel_prep_gives_plain_answer():
    """match_kernel's inputs through K3's preparation and launch (their
    plain restatement on the CPU) give best_target_plain's answer, on the
    ungated pass and on a gated one."""
    from ssrlcv_tpu_torch.bench.match_kernel import make_inputs
    from ssrlcv_tpu_torch.matching.match_kernel import best_target_plain, launch, prepare

    args = make_inputs(seed=3, nq=300, nt=500, device="cpu")
    rng = np.random.default_rng(4)
    p1 = torch.from_numpy(rng.uniform(0, 1024, (300, 2)).astype(np.float32))
    p2 = p1 + torch.from_numpy(rng.normal(0, 60, (300, 2)).astype(np.float32))
    gated = args[:3] + (p1, p2, 25.0) + args[6:]
    for a in (args, gated):
        idx, dist = launch(prepare(*a))
        want = best_target_plain(*a)
        assert torch.equal(idx, want[0]) and torch.equal(dist, want[1])
    assert torch.isfinite(launch(prepare(*args))[1]).all()
    assert not torch.isfinite(launch(prepare(*gated))[1]).all()


def test_scaling_on_a_one_rank_gloo_group():
    """The scaling driver's sharded matcher on a one-rank gloo group in
    process: one mesh size, and the single-device plain answer."""
    import torch.distributed as dist

    from ssrlcv_tpu_torch.bench.scaling import answer, make_inputs, mesh_sizes, sub_mesh
    from ssrlcv_tpu_torch.matching.match_kernel import best_target_plain
    from ssrlcv_tpu_torch.parallel.mesh import initialize_single

    q, t, tv = make_inputs(seed=1, n=256, device="cpu")
    created = initialize_single("gloo")
    try:
        assert mesh_sizes(dist.get_world_size()) == [1]
        idx, dist_ = answer(sub_mesh(1, "cpu"), q, t, tv)
    finally:
        if created:
            dist.destroy_process_group()
    inf2 = torch.full((256, 2), torch.inf)
    want = best_target_plain(q, t, torch.zeros(256, 2), inf2, inf2, 0.0, tv)
    assert torch.equal(idx, want[0]) and torch.equal(dist_, want[1])
    assert mesh_sizes(4) == [1, 2, 4]


DRIVERS = ["reconstruct", "profile_sift", "match_kernel", "nview", "pose", "dense", "scaling",
           "tester"]


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_stops_without_a_card(name, monkeypatch, tmp_path):
    """Every driver's main exits non-zero, with a message naming the
    missing CUDA device, before it loads or writes anything."""
    import importlib

    mod = importlib.import_module("ssrlcv_tpu_torch.tester" if name == "tester"
                                  else f"ssrlcv_tpu_torch.bench.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code not in (0, None) and "CUDA" in str(e.value.code)
    assert os.listdir(tmp_path) == []
