"""Feature capacity on the CPU: the port against the benchmark's plain
reference (``benchmark/reference/``) when SIFT's capacities cut features,
and a whole 2-view run at the capacity of a 2048^2 deployment (196,608).

``generate_features`` counts what it keeps and what it drops
(``.calls``, ``.features``, ``.dropped``); the counters are process-wide, so
each test reads their change over its own calls.
"""

import numpy as np
import pytest
import torch

SIZE = 256
# Stage 5 against the reference on the 2048^2 capacity's pair (scene 23):
# the first LM step's largest camera entry off the reference's by this
# share of the reference's step (reading: 4.1e-3 in position, one float32
# ulp of its 52 km coordinate; 2.6e-4 in rotation), and the errors after
# one and ten steps within this relative bound (readings 4.4e-4, 5.3e-4;
# ``test_bundle_adjust_modes_match_jax``'s bound).  The reference against
# itself with its tracks reversed reads the same after one step.
STEP_RTOL = 1e-2
BA_RTOL = 1e-3


@pytest.fixture(scope="module")
def scene():
    from benchmark.scene import make_scene

    return make_scene(11, SIZE, 2, "cpu")


def _counters():
    from ssrlcv_tpu_torch.features.sift import generate_features

    return np.array([generate_features.calls, generate_features.features,
                     generate_features.dropped])


def _assert_same_features(a, b):
    """Two FeatureSets (the port's, the reference's) equal to the bit."""
    assert a.capacity == b.capacity
    for name in ("loc", "sigma", "theta", "descriptors", "parent", "mask"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _both(pixels, cap: int, image_id: int = 0):
    """(port, reference) features of ``pixels`` at ``max_keypoints`` cap,
    and the port's counters' change."""
    from benchmark.reference.config import SIFTParams as RParams
    from benchmark.reference.features.sift import generate_features as ref_sift
    from ssrlcv_tpu_torch.config import SIFTParams
    from ssrlcv_tpu_torch.features.sift import generate_features

    before = _counters()
    got = generate_features(pixels, SIFTParams(max_keypoints=cap), image_id, device="cpu")
    counted = _counters() - before
    return got, ref_sift(pixels, RParams(max_keypoints=cap), image_id, device="cpu"), counted


def test_max_keypoints_cut_matches_reference_and_is_counted(scene):
    """At a max_keypoints below the view's count: the port's FeatureSet
    equals the reference's to the bit, and ``dropped`` is the reference's
    count at full capacity less the cap."""
    px = scene.views[0].pixels
    _, full, _ = _both(px, 8192)
    n_full = int(full.mask.sum())
    cap = 1024
    assert n_full > cap + 100
    got, ref, counted = _both(px, cap)
    _assert_same_features(got, ref)
    assert int(got.mask.sum()) == cap
    assert counted.tolist() == [1, cap, n_full - cap]


def test_full_capacity_drops_nothing(scene):
    """With room for every feature: nothing dropped, every kept feature
    counted, the same features as the reference's."""
    got, ref, counted = _both(scene.views[1].pixels, 4096, image_id=1)
    _assert_same_features(got, ref)
    assert counted.tolist() == [1, int(ref.mask.sum()), 0]


def _reference_extrema(pixels, params) -> list:
    """The reference's extrema of each octave (the noise prefilter of
    ``find_keypoints_octave`` applied), at a capacity that holds them all."""
    from benchmark.reference.core.device import as_device_tensor
    from benchmark.reference.features import scale_space as ss
    from benchmark.reference.features.detector import detect_extrema

    px = as_device_tensor(pixels, "cpu")
    counts = []
    for o, octave in enumerate(ss.build_scale_space(px, params, SIZE, SIZE)):
        sigmas = tuple(ss.octave_sigmas(params, o))[: params.blurs_per_octave - 1]
        kps = detect_extrema(octave.dog_raw, sigmas, octave.dog_raw.numel(),
                             prefilter_threshold=params.noise_threshold * 0.8)
        counts.append(int(kps.mask.sum()))
    return counts


def test_octave_capacity_cut_matches_reference_and_is_counted(scene, monkeypatch):
    """With every octave's detection capacity cut to 256 extrema (both
    sides): the same FeatureSet as the reference's, and ``dropped`` is the
    reference's extrema past 256, summed over the octaves."""
    from benchmark.reference.config import SIFTParams as RParams
    from benchmark.reference.features import sift as ref_sift_mod
    from ssrlcv_tpu_torch.features import sift as sift_mod

    cap = 256
    px = scene.views[0].pixels
    extrema = _reference_extrema(px, RParams(max_keypoints=4096))
    assert extrema[0] > 4 * cap
    for mod in (sift_mod, ref_sift_mod):
        monkeypatch.setattr(mod, "octave_capacity", lambda *a: cap)
    got, ref, counted = _both(px, 4096)
    _assert_same_features(got, ref)
    n = int(ref.mask.sum())
    assert 0 < n < 4096
    assert counted.tolist() == [1, n, sum(max(e - cap, 0) for e in extrema)]


def test_run_pipeline_at_the_2048_capacity_matches_reference(tmp_path):
    """A 128^2 pair and its seed image through ``run_pipeline`` at
    max_keypoints 196,608 (the 2048^2 deployment's capacity): the features,
    the filtered tracks and the initial and filtered clouds equal the
    reference's, run at a capacity of 2048 that also holds every feature (a
    run that drops nothing does not depend on its capacity), and nothing is
    dropped.  One thread: bundle adjustment's float32 sums then go in one
    order a call.

    Stage 5 against the reference, whose derivatives sum the same per-track
    terms in another float32 order (its per-slot gather against the
    program's sum over the tracks): the initial error equal to the bit; the
    first LM step from the same cameras within ``STEP_RTOL`` of the
    reference's step; the errors after one step and after the pipeline's
    ten within ``BA_RTOL``; the ten steps' cameras nearer the reference's
    than the reference's own step is long; the adjusted cloud the
    reference's triangulation through the program's cameras
    (``compare.ba_readings``).  The adjusted cloud and errors also equal
    the program's own bundle adjustment of the reference's filtered tracks:
    the capacity changes nothing there either."""
    import dataclasses

    from benchmark import compare, harness as H
    from benchmark.reference import config as reference_config
    from benchmark.reference.ba.two_view import bundle_adjust as reference_bundle_adjust
    from benchmark.reference.core.types import MatchSet as ReferenceMatchSet
    from benchmark.reference.pipeline import cameras_of, reconstruct
    from benchmark.scene import make_scene
    from ssrlcv_tpu_torch import config as program_config
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.io.refdata import RefImage
    from ssrlcv_tpu_torch.pipeline.stages import PipelineState, run_pipeline

    cfg = H.load_json("configs", "pair2v2048.json")
    assert cfg["sift"]["max_keypoints"] == 196608
    sc = make_scene(23, 128, 2, "cpu")
    pcfg = H.pipeline_config(program_config, cfg, output_dir=str(tmp_path))
    small = dict(cfg, sift=dict(cfg["sift"], max_keypoints=2048))
    rcfg = H.pipeline_config(reference_config, small)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        before = _counters()
        seed = generate_features(sc.seed.pixels, pcfg.sift, -1, device="cpu")
        images = [RefImage(**dataclasses.asdict(v)) for v in sc.views]
        state = run_pipeline(PipelineState(config=pcfg, images=images, device="cpu",
                                           seed_features=seed))
        counted = _counters() - before
        ref = reconstruct(sc.views, sc.seed.pixels, rcfg, "cpu")
        got, want = compare.from_program(state, seed, str(tmp_path)), compare.from_reference(ref)
        own = bundle_adjust(MatchSet.from_numpy(**want.matches),
                            cameras_from_refimages(images, "cpu"), pcfg.ba)
        ref_ba = compare.reference_ba(got, sc.views, rcfg, "cpu")
        step = bundle_adjust(MatchSet.from_numpy(**want.matches),
                             cameras_from_refimages(images, "cpu"),
                             dataclasses.replace(pcfg.ba, iterations=1))
        ref_step = reference_bundle_adjust(ReferenceMatchSet.from_numpy(device="cpu", **want.matches),
                                           cameras_of(sc.views, "cpu"),
                                           dataclasses.replace(rcfg.ba, iterations=1))
    finally:
        torch.set_num_threads(threads)
    assert all(f.capacity == 196608 for f in state.features + [seed])
    assert counted[0] == 3 and counted[2] == 0
    assert counted[1] == sum(len(f["sigma"]) for f in want.features)
    for a, b in zip(got.features, want.features):
        assert 0 < len(b["sigma"]) < 2048
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert got.matches["mask"].sum() > 50
    for k in got.matches:
        np.testing.assert_array_equal(got.matches[k], want.matches[k])
    for name in ("initial", "filtered"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.ba_error[0] == want.ba_error[0] and got.ba_error[1] < got.ba_error[0]
    assert got.ba_error[1] == pytest.approx(want.ba_error[1], rel=BA_RTOL)
    assert float(step.final_error) == pytest.approx(float(ref_step.final_error), rel=BA_RTOL)
    start = ref_ba["cameras0"]
    for cams, ref_cams, bound in ((compare.cameras_arrays(step.cameras),
                                   compare.cameras_arrays(ref_step.cameras), STEP_RTOL),
                                  (got.ba_cameras, want.ba_cameras, 1.0)):
        for a, b, a0 in zip(cams, ref_cams, start):   # (pos, rot)
            length = np.abs(b.astype(np.float64) - a0).max()
            assert length > 0
            assert np.abs(a.astype(np.float64) - b).max() < bound * length
    assert compare.ba_readings(got, ref_ba) == {"ba_cloud_pct": 0.0, "ba_stalled_pct": 0.0}
    np.testing.assert_array_equal(got.ba_points, own.cloud.points.numpy()[want.matches["mask"]])
    assert got.ba_error == (float(own.initial_error), float(own.final_error))


@pytest.mark.parametrize("case", ["gated", "ungated", "no_valid_target", "no_query"])
def test_chunked_matcher_over_valid_targets_matches_reference(case):
    """``best_target_chunked`` computes over the valid targets alone: the
    same (idx, dist) as the reference's pass over every capacity row, with
    invalid targets between valid ones, a tie across an invalid gap (the
    lower index wins), a query that no target passes ((0, +inf)), chunks
    that do not divide the queries, no valid target at all, and no query."""
    from benchmark.reference.matching.distance import best_target_chunked as ref_chunked
    from benchmark.reference.matching.match_kernel import epipolar_segment_mask as ref_gate
    from ssrlcv_tpu_torch.matching.distance import best_target_chunked
    from ssrlcv_tpu_torch.matching.match_kernel import epipolar_segment_mask

    rng = np.random.default_rng(41)
    nq, nt = (0 if case == "no_query" else 300), 700
    q = torch.from_numpy(rng.integers(0, 256, (nq, 128)).astype(np.uint8))
    t = torch.from_numpy(rng.integers(0, 256, (nt, 128)).astype(np.uint8))
    t_loc = torch.from_numpy(rng.uniform(0, 256, (nt, 2)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=nt) < 0.4)
    valid[[5, 6, 400]] = torch.tensor([True, False, True])
    t[6] = t[5]
    t[400] = t[5]
    if nq:
        q[3] = t[5]
        q[4] = t[6]  # its twin is invalid
    if case == "no_valid_target":
        valid[:] = False
    p1 = torch.from_numpy(rng.uniform(0, 256, (nq, 2)).astype(np.float32))
    p2 = p1 + torch.from_numpy(rng.uniform(-60, 60, (nq, 2)).astype(np.float32))
    if nq:
        p1[3], p2[3] = t_loc[5] - 10, t_loc[5] + 10
        p1[7], p2[7] = torch.tensor([5000.0, 5000.0]), torch.tensor([5100.0, 5200.0])
    kw, ref_kw = {}, {}
    if case != "ungated":
        kw = {"mask_fn": lambda a, b, tl: epipolar_segment_mask(a, b, tl, 25.0),
              "mask_aux": (p1, p2), "t_aux": (t_loc,)}
        ref_kw = {"mask_fn": lambda a, b: ref_gate(a, b, t_loc, 25.0), "mask_aux": (p1, p2)}
    idx, dist = best_target_chunked(q, t, valid, chunk=128, **kw)
    want_idx, want_dist = ref_chunked(q, t, valid, chunk=128, **ref_kw)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32 and idx.shape == (nq,)
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)
    if case in ("gated", "ungated"):
        assert int(idx[3]) == 5 and float(dist[3]) == 0.0
        assert int(idx[4]) != 6
    if case == "gated":
        assert int(idx[7]) == 0 and float(dist[7]) == float("inf")
    if case == "no_valid_target":
        assert (idx == 0).all() and torch.isinf(dist).all()
