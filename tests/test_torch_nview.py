"""The port's N-view modules against their JAX twins, on the CPU.

Same numpy-seeded inputs through ssrlcv_tpu and ssrlcv_tpu_torch: N-view
triangulation and the N-view filter on a 3-view rig made from the synthetic
scene's cameras, track building on a hand-built and a random graph,
exhaustive matching on identical features of the 256x256 3-view scene, and
N-view bundle adjustment.  Besides, the MatchSet assembly from slot rows and
the native track builder's argument checks, which need no card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import (HAND_BUILT_GRAPH, TRACK_GRAPHS, _matchset_restated, _same_matchset,
                             _track_graph, _track_locs)

torch.set_num_threads(2)


def _port(value, cls):
    return cls.from_numpy(**{f.name: np.asarray(getattr(value, f.name))
                             for f in dataclasses.fields(value)})


def _rig(n=300, cap=384, seed=0):
    """3-view tracks of points on the scene's true surface, projected into
    each view with 0.3 px noise; 50 tracks keep only views 0 and 1, and the
    capacity is padded.  Returns (JAX Cameras, MatchSet arrays)."""
    from ssrlcv_tpu.core import camera_math as cm
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=0, size=64, n_views=3)
    cams = cameras_from_refimages(scene.images)
    rng = np.random.default_rng(seed)
    loc0 = rng.uniform(5, 59, (n, 2)).astype(np.float32)
    ground = scene.ground_points(loc0) + np.asarray(scene.images[0].ecef_offset, np.float64)
    locs = [loc0]
    for k in (1, 2):
        P = np.asarray(cm.projection_matrix(cams.cam_pos[k], cams.cam_rot[k], cams.foc[k],
                                            cams.dpix[k], cams.size[k], cams.ecef_offset[k]))
        pr = P @ np.concatenate([ground, np.ones((n, 1))], 1).T.astype(np.float32)
        locs.append(((pr[:2] / pr[2]).T + rng.normal(0, 0.3, (n, 2))).astype(np.float32))
    kp_loc = np.zeros((cap, 3, 2), np.float32)
    kp_loc[:n] = np.stack(locs, 1)
    par = np.full((cap, 3), -1, np.int32)
    par[:n] = [0, 1, 2]
    nv = np.zeros(cap, np.int32)
    nv[:n] = 3
    nv[:50], par[:50, 2], kp_loc[:50, 2] = 2, -1, 0.0
    return cams, dict(kp_loc=kp_loc, kp_parent=par, num_views=nv, mask=np.arange(cap) < n)


def _both(arrays):
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu_torch.core.types import MatchSet as TMS

    return JMS(**{k: jnp.asarray(v) for k, v in arrays.items()}), TMS.from_numpy(**arrays)


def test_nview_types_match_jax():
    """MatchSet.from_flat / empty / max_views and Cameras.stack /
    __getitem__ against the JAX types on the same arrays."""
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu_torch.core.types import Cameras, MatchSet as TMS

    rng = np.random.default_rng(4)
    mm_num = np.array([2, 3, 2, 3], np.int32)
    mm_index = np.concatenate([[0], np.cumsum(mm_num)[:-1]]).astype(np.int32)
    kp_loc = rng.uniform(0, 64, (int(mm_num.sum()), 2)).astype(np.float32)
    kp_par = np.concatenate([np.arange(n) for n in mm_num]).astype(np.int32)
    for kw in ({}, {"capacity": 8, "max_views": 4}):
        j = JMS.from_flat(kp_par, kp_loc, mm_num, mm_index, **kw)
        t = TMS.from_flat(kp_par, kp_loc, mm_num, mm_index, **kw)
        assert t.max_views == j.max_views and t.capacity == j.capacity
        for f in dataclasses.fields(t):
            np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                          np.asarray(getattr(j, f.name)), f.name)
    e = TMS.empty(16, 3)
    je = JMS.empty(16, 3)
    for f in dataclasses.fields(e):
        np.testing.assert_array_equal(getattr(e, f.name).numpy(), np.asarray(getattr(je, f.name)))

    cams, _ = _rig()
    tc = _port(cams, Cameras)
    for got, want in ((Cameras.stack([tc[:1], tc[1:]]), cams),
                      (tc[2:], cams[2:]), (tc[[2, 0]], cams[np.array([2, 0])])):
        assert got.num_cameras == want.num_cameras
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)), f.name)


@pytest.mark.parametrize("reference_error_mode", [False, True])
def test_n_view_triangulate_matches_jax(reference_error_mode):
    """Masks equal; points within 1e-3 km (median) and 2e-2 km (max, the
    JAX package's own float32 solve-noise bound against the reference);
    total error rtol 1e-3, per-point errors within 1e-6 km^2.  The
    per-point spread is float32 rounding of S and C (XLA fuses their
    multiply-adds on the CPU) amplified along the poorly conditioned depth
    direction; on the same S and C the two solves agree to about 1 m."""
    from ssrlcv_tpu.geometry.bundles import generate_bundles as jgb
    from ssrlcv_tpu.geometry.triangulation import n_view_triangulate as jnv
    from ssrlcv_tpu_torch.core.types import Cameras
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles as tgb
    from ssrlcv_tpu_torch.geometry.triangulation import n_view_triangulate as tnv

    cams, arrays = _rig()
    jms, tms = _both(arrays)
    jpc, jtot = jnv(jgb(jms, cams), reference_error_mode=reference_error_mode)
    tpc, ttot = tnv(tgb(tms, _port(cams, Cameras)), reference_error_mode=reference_error_mode)
    m = np.asarray(jpc.mask)
    np.testing.assert_array_equal(tpc.mask.numpy(), m)
    assert m.sum() == 300
    d = np.linalg.norm(tpc.points.numpy()[m] - np.asarray(jpc.points)[m], axis=1)
    assert np.median(d) <= 1e-3 and d.max() <= 2e-2
    assert float(ttot) == pytest.approx(float(jtot), rel=1e-3)
    np.testing.assert_allclose(tpc.errors.numpy(), np.asarray(jpc.errors), rtol=0, atol=1e-6)


def test_nview_filters_match_jax():
    """The N-view deterministic statistical filter (reference error mode)
    and the linear cutoff: identical masks; reduce_bundle_set and
    compact_matchset identical."""
    from ssrlcv_tpu.geometry import filters as JF
    from ssrlcv_tpu_torch.core.types import Cameras
    from ssrlcv_tpu_torch.geometry import filters as TF

    cams, arrays = _rig()
    arrays["kp_loc"][[61, 77, 150], 2] += 6.0  # gross outliers for the filters
    jms, tms = _both(arrays)
    tc = _port(cams, Cameras)
    j = JF.deterministic_statistical_filter(jms, cams, 3.0, 10, two_view=False)
    t = TF.deterministic_statistical_filter(tms, tc, 3.0, 10, two_view=False)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert 0 < t.count() < 300 and not t.mask[[61, 77, 150]].any()
    cut = 5e-5
    j = JF.linear_cutoff_filter(jms, cams, cut, two_view=False)
    t = TF.linear_cutoff_filter(tms, tc, cut, two_view=False)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert 0 < t.count() < 300
    for jr, tr in ((JF.reduce_bundle_set(jms, 0.25), TF.reduce_bundle_set(tms, 0.25)),
                   (JF.compact_matchset(j), TF.compact_matchset(t))):
        for k in ("kp_loc", "kp_parent", "num_views", "mask"):
            np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)))


def test_nondeterministic_filter_draws_valid_tracks():
    """The random-sample filter: a generator makes it reproducible, and its
    cutoff lies near the deterministic filter's on the same tracks."""
    from ssrlcv_tpu_torch.core.types import Cameras, MatchSet
    from ssrlcv_tpu_torch.geometry import filters as TF

    cams, arrays = _rig()
    arrays["kp_loc"][[61, 77, 150], 2] += 6.0
    ms, tc = MatchSet.from_numpy(**arrays), _port(cams, Cameras)
    runs = [TF.nondeterministic_statistical_filter(ms, tc, torch.Generator().manual_seed(3), 3.0,
                                                   4000, two_view=False) for _ in range(2)]
    assert torch.equal(runs[0].mask, runs[1].mask)
    det = TF.deterministic_statistical_filter(ms, tc, 3.0, 10, two_view=False)
    assert (runs[0].mask == det.mask).float().mean() >= 0.95
    assert not runs[0].mask[[61, 77, 150]].any() and not runs[0].mask[300:].any()


def _random_graph(seed=7, n_img=4, n_feat=60):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_img - 1):
        for j in range(i + 1, n_img):
            q = np.sort(rng.choice(n_feat, 35, replace=False))
            out[(i, j)] = np.stack([q, rng.integers(0, n_feat, 35)], axis=1).astype(np.int64)
    return out, n_img, [n_feat] * n_img


@pytest.mark.parametrize("graph", ["hand_built", "random"])
def test_build_tracks_matches_jax(graph):
    """The hand-built 3-image graph of tests/test_nview_golden.py and a
    seeded random 4-image graph: identical track lists."""
    from ssrlcv_tpu.matching.tracks import build_tracks as jbt
    from ssrlcv_tpu_torch.matching.tracks import build_tracks as tbt

    if graph == "hand_built":
        pm, n, counts = ({(0, 1): np.array([[0, 5], [1, 6], [2, 7]]),
                          (0, 2): np.array([[0, 9], [2, 11]]),
                          (1, 2): np.array([[5, 9], [6, 10], [7, 12]])}, 3, [16, 16, 16])
    else:
        pm, n, counts = _random_graph()
    jt, tt = jbt(pm, n, counts), tbt(pm, n, counts)
    assert tt == jt and len(tt) > 0
    if graph == "hand_built":
        assert tt == [[(0, 0), (1, 5), (2, 9)]]


@pytest.fixture(scope="module")
def scene3_features():
    """JAX SIFT of the 256x256 3-view scene and its seed image."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.sift import generate_features
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=0, size=256, n_views=3)
    sp = SIFTParams(max_keypoints=4096)
    feats = [generate_features(im.pixels, sp, image_id=im.id) for im in scene.images]
    seed = generate_features(scene.seed_image.pixels, sp, image_id=-1)
    return feats, seed, cameras_from_refimages(scene.images)


def test_generate_matches_exhaustive_matches_jax(scene3_features):
    """Identical features in, identical tracks out: kp_loc, kp_parent,
    num_views and mask equal (matching is exact)."""
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.matching.tracks import generate_matches_exhaustive as jgme
    from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet
    from ssrlcv_tpu_torch.matching.tracks import generate_matches_exhaustive as tgme

    feats, seed, cams = scene3_features
    mp = MatchParams(epsilon=25.0, delta=5.0)
    jm = jgme(feats, cams, mp, seed_features=seed)
    tm = tgme([_port(f, FeatureSet) for f in feats], _port(cams, Cameras), mp,
              seed_features=_port(seed, FeatureSet))
    for k in ("kp_loc", "kp_parent", "num_views", "mask"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), k)
    nv = tm.num_views.numpy()[tm.mask.numpy()]
    assert tm.count() > 500 and (nv == 3).sum() > 100 and (nv == 2).sum() > 100


def _no_library():
    raise AssertionError("the kernel library was asked for")


def test_generate_matches_exhaustive_cpu_takes_the_python_builder(scene3_features, monkeypatch):
    """CPU features: no library is built, the MatchSet is the Python
    builder's tracks assembled slot by slot, and the counters count a call
    and no native call."""
    from ssrlcv_tpu_torch import _cuda
    from ssrlcv_tpu_torch.config import MatchParams
    from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet
    from ssrlcv_tpu_torch.matching import tracks as TR

    monkeypatch.setattr(_cuda, "library", _no_library)
    feats, seed, cams = scene3_features
    tf = [_port(f, FeatureSet) for f in feats]
    tc, ts = _port(cams, Cameras), _port(seed, FeatureSet)
    mp = MatchParams(epsilon=25.0, delta=5.0)
    calls, native = TR.generate_matches_exhaustive.calls, TR.generate_matches_exhaustive.native_calls
    got = TR.generate_matches_exhaustive(tf, tc, mp, seed_features=ts)
    assert TR.generate_matches_exhaustive.calls == calls + 1
    assert TR.generate_matches_exhaustive.native_calls == native
    tracks = TR.build_tracks(TR.pairwise_index_matches(tf, tc, mp, ts), 3,
                             [f.capacity for f in tf])
    _same_matchset(got, _matchset_restated(tracks, [f.loc.numpy() for f in tf], "cpu"))


FIXED_GRAPHS = {"hand_built": HAND_BUILT_GRAPH, "empty": ({}, 3, [16, 16, 16])}


@pytest.mark.parametrize("case", list(FIXED_GRAPHS) + TRACK_GRAPHS)
def test_matchset_from_slot_rows_equals_restatement(case):
    """``_matchset`` over ``track_slots`` of the Python builder's tracks
    equals the slot-by-slot assembly, byte for byte, on the card tests'
    graphs."""
    from ssrlcv_tpu_torch.core.types import FeatureSet
    from ssrlcv_tpu_torch.matching import tracks as TR

    pm, n, counts = FIXED_GRAPHS[case] if case in FIXED_GRAPHS else _track_graph(*case)
    tracks = TR.build_tracks(pm, n, counts)
    locs = _track_locs(counts)
    feats = [FeatureSet.empty(len(loc)) for loc in locs]
    for f, loc in zip(feats, locs):
        f.loc.copy_(torch.from_numpy(loc))
    got = TR._matchset(TR.track_slots(tracks), len(tracks), feats)
    _same_matchset(got, _matchset_restated(tracks, locs, "cpu"))


def test_track_graphs_hold_their_cases():
    """The card tests' graphs hold what they are said to: empty pairs,
    ordered-overlap pair subsets, two roots hitting one hop, roots with
    matches and no track (chains that fail the subset check), and tracks
    whose first hop an earlier root of the same image consumed."""
    from ssrlcv_tpu_torch.matching import tracks as TR

    empty = ordered_subsets = shared = no_track = consumed = 0
    for seed, n, ordered in TRACK_GRAPHS:
        pm, _, counts = _track_graph(seed, n, ordered)
        empty += sum(len(r) == 0 for r in pm.values())
        ordered_subsets += ordered and len(pm) < n * (n - 1) // 2
        tracks = TR.build_tracks(pm, n, counts)
        for (i, j), rows in pm.items():
            shared += len(np.unique(rows[:, 1])) < len(rows)
        roots = {tr[0] for tr in tracks}
        members = {hop for tr in tracks for hop in tr[1:]}
        no_track += sum((i, int(q)) not in roots and (i, int(q)) not in members
                        for (i, j), rows in pm.items() if i < n - 2 for q in rows[:, 0])
        seen = set()
        for tr in tracks:
            consumed += (tr[0][0], tr[1]) in seen
            seen.update((tr[0][0], hop) for hop in tr[1:-1] if hop[0] != n - 1)
    assert empty and ordered_subsets and shared and no_track and consumed, \
        (empty, ordered_subsets, shared, no_track, consumed)


def test_build_track_slots_refuses_bad_arguments(monkeypatch):
    """The native builder's checks raise before the C call: wrong dtypes,
    shapes, image pairs and feature indices."""
    from ssrlcv_tpu_torch import _cuda
    from ssrlcv_tpu_torch.matching.tracks import build_track_slots

    monkeypatch.setattr(_cuda, "library", _no_library)
    ok = np.array([[0, 1], [2, 3]], np.int64)
    for bad, err in ((ok.astype(np.int32), TypeError), (ok.tolist(), TypeError),
                     (ok.astype(np.float64), TypeError), (ok[:, :1], ValueError),
                     (ok.ravel(), ValueError), (np.zeros((2, 3), np.int64), ValueError),
                     (np.array([[0, 17]], np.int64), ValueError),
                     (np.array([[-1, 0]], np.int64), ValueError)):
        with pytest.raises(err):
            build_track_slots({(0, 1): ok, (0, 2): bad}, 3, [16, 16, 16])
    for pair in ((1, 0), (0, 3), (-1, 1), (1, 1)):
        with pytest.raises(ValueError, match="image pair"):
            build_track_slots({pair: ok}, 3, [16, 16, 16])


def test_match_index_only_threshold_matches_jax(scene3_features):
    """match_double_constrained with and without index_only against JAX on
    the same features and seed distances: identical valid masks for each
    flag, and the two flags' masks differ (the unsquared threshold keeps
    more)."""
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.matching import match as JM
    from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet
    from ssrlcv_tpu_torch.matching import match as TM

    feats, seed, cams = scene3_features
    mp = MatchParams(epsilon=25.0, delta=5.0)
    tf = [_port(f, FeatureSet) for f in feats[:2]]
    tc = _port(cams, Cameras)
    jsd = JM.seed_distances(feats[0], seed)
    tsd = TM.seed_distances(tf[0], _port(seed, FeatureSet))
    qm = np.asarray(feats[0].mask)  # K3 answers the slots in the mask, +inf elsewhere
    np.testing.assert_array_equal(tsd.numpy()[qm], np.asarray(jsd)[qm])
    assert np.isinf(tsd.numpy()[~qm]).all()
    masks = []
    for index_only in (False, True):
        j = JM.match_double_constrained(feats[0], feats[1], cams, 0, 1, mp, seed_dist=jsd,
                                        index_only=index_only)
        t = TM.match_double_constrained(tf[0], tf[1], tc, 0, 1, mp, seed_dist=tsd,
                                        index_only=index_only)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        masks.append(t.valid.numpy())
    assert masks[1].sum() > masks[0].sum() and (masks[1] | ~masks[0]).all()


@pytest.mark.parametrize("camera0", ["offset", "at_origin"])
def test_bundle_adjust_nview_matches_jax(camera0):
    """Three iterations from a perturbed camera 2.  "offset": camera 0 off
    the origin; initial error within rel 1e-3, final error below initial in
    both and within rel 1e-2 of JAX's (one float32 ulp on the camera
    positions moves the port's own final error by about that much), camera 0
    unchanged.  "at_origin": camera 0 at the origin, as the command line's
    ECEF offset puts it; a padding track's zero point-line cross product
    gives sqrt a NaN derivative in both packages, so neither takes a step."""
    from ssrlcv_tpu.ba.nview import bundle_adjust_nview as jba
    from ssrlcv_tpu.config import BAParams
    from ssrlcv_tpu_torch.ba.nview import bundle_adjust_nview as tba
    from ssrlcv_tpu_torch.core.types import Cameras

    cams, arrays = _rig()
    cams = cams.replace(cam_rot=cams.cam_rot.at[2].add(jnp.array([5e-5, -5e-5, 2e-5])))
    if camera0 == "at_origin":
        cams = cams.replace(cam_pos=cams.cam_pos - cams.cam_pos[0])
    jms, tms = _both(arrays)
    jr = jba(jms, cams, BAParams(iterations=3))
    tr = tba(tms, _port(cams, Cameras), BAParams(iterations=3))
    j0, j1, t0, t1 = (float(x) for x in (jr.initial_error, jr.final_error, tr.initial_error,
                                         tr.final_error))
    assert t0 == pytest.approx(j0, rel=1e-3)
    np.testing.assert_array_equal(tr.cameras.cam_pos.numpy()[0], np.asarray(cams.cam_pos)[0])
    np.testing.assert_array_equal(tr.cameras.cam_rot.numpy()[0], np.asarray(cams.cam_rot)[0])
    if camera0 == "offset":
        assert j1 < j0 and t1 < t0
        assert t1 == pytest.approx(j1, rel=1e-2)
    else:
        assert j1 == j0 and t1 == t0
        np.testing.assert_array_equal(tr.cameras.cam_rot.numpy(), np.asarray(cams.cam_rot))
    assert tr.cloud.mask.sum() == 300


def _with_singular_tracks(bundles):
    """``bundles`` with tracks appended whose least-squares system is
    singular: one view, two parallel rays along an axis, no view at all."""
    from ssrlcv_tpu_torch.core.types import Bundles

    # no ray passes through the origin, where a masked track's point lies
    vec = torch.tensor([0.0, 1.0, 0.0]).repeat(3, 3, 1)
    pnt = torch.tensor([5.0, -7.0, 11.0]).repeat(3, 3, 1)
    vec[0, 0] = torch.tensor([1.0, 0.0, 0.0])
    vec[1, :2] = torch.tensor([0.0, 0.0, 1.0])
    pnt[1, 1] = torch.tensor([8.0, -7.0, 11.0])
    return Bundles(vec=torch.cat([bundles.vec, vec]), pnt=torch.cat([bundles.pnt, pnt]),
                   num_views=torch.cat([bundles.num_views,
                                        torch.tensor([1, 2, 0], dtype=torch.int32)]),
                   mask=torch.cat([bundles.mask, torch.tensor([True, True, False])]))


@pytest.mark.parametrize("singular", [False, True], ids=["rig", "singular_tracks"])
def test_n_view_triangulate_equals_its_checked_solve(singular, monkeypatch):
    """``n_view_triangulate`` solves with ``torch.linalg.solve_ex``, which
    waits for no check of the solution: its cloud, total and the total's
    gradient over the rays equal those of ``torch.linalg.solve`` to the bit,
    on the rig's tracks and on tracks whose system is singular (masked
    before the solve)."""
    from torch.func import grad

    from ssrlcv_tpu_torch.core.types import Cameras
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import n_view_triangulate

    cams, arrays = _rig()
    _, tms = _both(arrays)
    bundles = generate_bundles(tms, _port(cams, Cameras))
    if singular:
        bundles = _with_singular_tracks(bundles)

    def run():
        pc, total = n_view_triangulate(bundles)
        d_vec = grad(lambda v: n_view_triangulate(bundles.replace(vec=v))[1])(bundles.vec)
        return pc.points, pc.errors, pc.mask, total, d_vec

    got = run()
    monkeypatch.setattr(torch.linalg, "solve_ex",
                        lambda A, B: (torch.linalg.solve(A, B), None))
    want = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mask = got[2]
    assert int(mask.sum()) == 300 and not bool(mask[-3:].any())
