"""The port's matching additions against the JAX package, on the CPU: K4's
plain version against the Pallas kernel ``_match_kernel`` in interpret mode,
brute-force and F-matrix constrained matching, the fundamental matrix, and
the match-list utilities (mirroring tests/test_matching.py)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import _mma_case, _mma_tile_case, _skip_case

torch.set_num_threads(2)


def _jax_k4(q, t, t_loc, p1, p2, eps, t_valid):
    """_match_prep then _match_kernel through pl.pallas_call in interpret
    mode, with the call spec of pallas_match._match_call restated here
    (_match_call itself compiles for the TPU)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from ssrlcv_tpu.matching.pallas_match import (QUERY_TILE as QT, TARGET_TILE as TT,
                                                  _match_kernel, _match_prep)

    args = _match_prep(q, t, t_loc, p1, p2, eps, t_valid)
    nq_pad, nt_pad = args[2].shape[0], args[4].shape[0]
    q_spec = partial(pl.BlockSpec, (QT, 128), lambda i, j: (i, 0))
    t_spec = partial(pl.BlockSpec, (TT, 128), lambda i, j: (j, 0))
    out_spec = partial(pl.BlockSpec, (QT, 1), lambda i, j: (i, 0))
    idx, dist = pl.pallas_call(
        _match_kernel,
        grid=(nq_pad // QT, nt_pad // TT),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.SMEM),
                  q_spec(), q_spec(), t_spec(), t_spec(),
                  pl.BlockSpec((2, TT), lambda i, j: (0, j)),
                  pl.BlockSpec((QT, 2), lambda i, j: (i, 0)),
                  pl.BlockSpec((QT, 2), lambda i, j: (i, 0))],
        out_specs=[out_spec(), out_spec()],
        out_shape=[jax.ShapeDtypeStruct((nq_pad, 1), jnp.int32),
                   jax.ShapeDtypeStruct((nq_pad, 1), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((QT,), jnp.float32), pltpu.VMEM((QT,), jnp.int32)],
        interpret=True,
    )(*args)
    nq = q.shape[0]
    return np.asarray(idx)[:nq, 0], np.asarray(dist)[:nq, 0]


def test_best_target_mma_plain_matches_jax_pallas_interpret():
    """K4's plain version bit-identical to _match_kernel (Nq 256, Nt 1024:
    an all-masked query, invalid targets, a vertical segment, a tie,
    unconstrained rows), and to K3's plain version on every query with an
    admissible target; the others get (0, 3.0e38)."""
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.matching.match_mma import NO_MATCH_DIST, best_target_mma

    eps = 25.0
    case = _mma_case()
    ji, jd = _jax_k4(*(jnp.asarray(a) for a in case[:5]), jnp.float32(eps),
                     jnp.asarray(case[5]))
    targs = [torch.from_numpy(a) for a in case[:5]]
    tv = torch.from_numpy(case[5])
    idx, dist = best_target_mma(*targs, eps, tv)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(dist.numpy(), jd)

    i3, d3 = best_target(*targs, eps, tv)
    answered = np.isfinite(d3.numpy())
    assert 100 < answered.sum() < len(answered)
    np.testing.assert_array_equal(idx.numpy()[answered], i3.numpy()[answered])
    np.testing.assert_array_equal(dist.numpy()[answered], d3.numpy()[answered])
    assert (idx.numpy()[~answered] == 0).all()
    assert (dist.numpy()[~answered] == np.float32(NO_MATCH_DIST)).all()
    assert not answered[6] and idx[200] == 300 and dist[200] == 0.0


@pytest.mark.parametrize("case", ["tile_schedule", "mma"])
def test_best_target_mma_tiled_matches_plain_and_jax(case):
    """The restatement of K4's tile schedule and packed-key tie rule
    (best_target_mma_tiled) bit-identical to best_target_mma_plain and to
    the Pallas _match_kernel in interpret mode: equal distances inside one
    tile (the higher index first in K3's spatial order) and across tiles, an
    inadmissible target inside a live tile, tiles of padding only,
    descriptors of all 255 against all 0 (d = 8,323,200) and against all
    255, a valid target with a NaN location, queries with no admissible
    target ((0, 3.0e38)), Nq not a multiple of 128."""
    from ssrlcv_tpu_torch.matching.match_kernel import TT, live_tiles, spatial_order, tile_boxes
    from ssrlcv_tpu_torch.matching.match_mma import (NO_MATCH_DIST, admissible,
                                                     best_target_mma_plain,
                                                     best_target_mma_tiled, tile_sorted)

    eps = 25.0
    arrays, rows = _mma_tile_case() if case == "tile_schedule" else (_mma_case()[:6], {})
    targs = [torch.from_numpy(a) for a in arrays]
    it, dt = best_target_mma_tiled(*targs[:5], eps, targs[5])
    ip, dp = best_target_mma_plain(*targs[:5], eps, targs[5])
    assert torch.equal(it, ip) and torch.equal(dt, dp)
    ji, jd = _jax_k4(*(jnp.asarray(a) for a in arrays[:5]), jnp.float32(eps),
                     jnp.asarray(arrays[5]))
    np.testing.assert_array_equal(it.numpy(), ji)
    np.testing.assert_array_equal(dt.numpy(), jd)
    if not rows:
        return
    got = {name: (int(it[r]), float(dt[r])) for name, r in rows.items()}
    none = (0, float(np.float32(NO_MATCH_DIST)))
    assert got == {"tie_in_tile": (50, 0.0), "tie_across": (20, 0.0),
                   "far": (800, 128 * 255 ** 2), "same_max": (801, 0.0),
                   "invalid_only": none, "nan_only": got["nan_only"], "nothing": none}
    assert got["nan_only"][0] != 802
    # the schedule's preconditions: 600 before 50 in K3's order, both in one
    # tile; 20 and 400 in two; a live tile that holds inadmissible slots; a
    # tile of padding only, live for no warp
    adm = admissible(targs[2], targs[5])
    qperm, k3_order = spatial_order(targs[2], adm, targs[3], targs[4])
    pos = torch.empty_like(k3_order)
    pos[k3_order] = torch.arange(len(k3_order))
    assert pos[600] < pos[50] and pos[600] // TT == pos[50] // TT
    assert pos[20] // TT != pos[400] // TT
    tperm = tile_sorted(k3_order)
    assert torch.equal(tperm.view(-1, TT).sort(1).values.view(-1), tperm)
    live = live_tiles(*tile_boxes(targs[2], targs[3], targs[4], eps, adm, None, qperm, tperm))
    per_tile = adm[tperm].view(-1, TT).sum(1)
    mixed = (per_tile > 0) & (per_tile < TT)
    assert mixed.any() and live[:, mixed].any()
    assert (per_tile == 0).any() and not live[:, per_tile == 0].any()


def _jax_k3(q, t, t_loc, p1, p2, eps, t_valid, qt=16, tt=128):
    """_match_prep_i8 then _match_kernel_i8 (with its y-band tile skip)
    through pl.pallas_call in interpret mode, with the call spec of
    pallas_match._match_call_i8 restated here, at the port's tile sizes
    (16 query rows, 128 targets).  Returns (idx, dist, qiv, tiv)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from ssrlcv_tpu.matching.pallas_match import _match_kernel_i8, _match_prep_i8

    args = _match_prep_i8(q, t, t_loc, p1, p2, eps, t_valid, qt=qt, tt=tt)
    nq_pad, nt_pad = args[3].shape[0], args[5].shape[0]
    smem = partial(pl.BlockSpec, memory_space=pltpu.SMEM)
    row_spec = partial(pl.BlockSpec, index_map=lambda i, j: (0, j))
    idx, dist = pl.pallas_call(
        partial(_match_kernel_i8, tt),
        grid=(nq_pad // qt, nt_pad // tt),
        in_specs=[smem(), smem(), smem(),
                  pl.BlockSpec((qt, 128), lambda i, j: (i, 0)),
                  pl.BlockSpec((qt, 1), lambda i, j: (i, 0)),
                  pl.BlockSpec((tt, 128), lambda i, j: (j, 0)),
                  row_spec((1, tt)), row_spec((1, tt)), row_spec((2, tt)),
                  pl.BlockSpec((qt, 2), lambda i, j: (i, 0)),
                  pl.BlockSpec((qt, 2), lambda i, j: (i, 0))],
        out_specs=[pl.BlockSpec((qt, 1), lambda i, j: (i, 0))] * 2,
        out_shape=[jax.ShapeDtypeStruct((nq_pad, 1), jnp.int32),
                   jax.ShapeDtypeStruct((nq_pad, 1), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((qt,), jnp.float32), pltpu.VMEM((qt,), jnp.int32)],
        interpret=True,
    )(*args)
    nq = q.shape[0]
    return (np.asarray(idx)[:nq, 0], np.asarray(dist)[:nq, 0], np.asarray(args[1]),
            np.asarray(args[2]))


def test_tile_intervals_match_jax_prep():
    """The y-band intervals K3 skips on, per 16 query rows and per 128
    targets in the rows' own order, equal _match_prep_i8's qiv / tiv at
    those tile sizes, with steep, vertical and unconstrained segments and
    invalid targets; q_valid false rows contribute the neutral interval, as
    padding does."""
    from ssrlcv_tpu.matching.pallas_match import _match_prep_i8
    from ssrlcv_tpu_torch.matching.match_kernel import (QW, TT, _per_tile, _row_bands,
                                                        _target_ranges)

    q, t, t_loc, p1, p2, t_valid, q_valid = _skip_case()
    args = _match_prep_i8(*(jnp.asarray(a) for a in (q, t, t_loc, p1, p2)), 25.0,
                          jnp.asarray(t_valid), qt=QW, tt=TT)
    tl, a, b, tv = (torch.from_numpy(x) for x in (t_loc, p1, p2, t_valid))
    qiv = _per_tile(*_row_bands(a, b, 25.0)[:2], QW)
    tiv = _per_tile(*_target_ranges(tl, tv)[2:], TT)
    np.testing.assert_array_equal(qiv.numpy(), np.asarray(args[1]).T)
    np.testing.assert_array_equal(tiv.numpy(), np.asarray(args[2]).T)
    assert np.isinf(qiv.numpy()[3]).all()                 # rows 48..63 are unconstrained
    qv = _per_tile(*_row_bands(a, b, 25.0, torch.zeros(len(q), dtype=torch.bool))[:2], QW)
    assert (qv[:, 0] == np.inf).all() and (qv[:, 1] == -np.inf).all()


@pytest.mark.parametrize("with_q_valid", [False, True])
def test_best_target_tiled_matches_plain_and_jax(with_q_valid):
    """The restatement of K3's tile-skip decisions (best_target_tiled) on
    y-sorted targets with steep, flat, vertical, zero-length and
    unconstrained segments: idx and dist identical to best_target_plain,
    with and without q_valid ((0, +inf) on its false rows), and to the
    Pallas _match_kernel_i8 (its own skip) on every answered row; the skip
    drops some tiles and keeps others."""
    from ssrlcv_tpu_torch.matching.match_kernel import (best_target, best_target_plain,
                                                        best_target_tiled, live_tiles,
                                                        spatial_order, tile_boxes)

    eps = 25.0
    q, t, t_loc, p1, p2, t_valid, q_valid = _skip_case()
    targs = [torch.from_numpy(a) for a in (q, t, t_loc, p1, p2)]
    tv = torch.from_numpy(t_valid)
    kw = {"q_valid": torch.from_numpy(q_valid)} if with_q_valid else {}
    it, dt = best_target_tiled(*targs, eps, tv, **kw)
    ip, dp = best_target_plain(*targs, eps, tv, **kw)
    np.testing.assert_array_equal(it.numpy(), ip.numpy())
    np.testing.assert_array_equal(dt.numpy(), dp.numpy())
    ib, db = best_target(*targs, eps, tv, **kw)  # the wrapper's CPU route
    np.testing.assert_array_equal(ib.numpy(), ip.numpy())
    np.testing.assert_array_equal(db.numpy(), dp.numpy())
    assert it[70] == 500 and dt[71] == np.inf

    ji, jd, _, _ = _jax_k3(*(jnp.asarray(a) for a in (q, t, t_loc, p1, p2)), jnp.float32(eps),
                           jnp.asarray(t_valid))
    answered = np.isfinite(dp.numpy())
    assert 100 < answered.sum() < len(q)
    np.testing.assert_array_equal(it.numpy()[answered], ji[answered])
    np.testing.assert_array_equal(dt.numpy()[answered], jd[answered])
    assert (jd[~answered & (q_valid if with_q_valid else True)] >= 3e38).all()
    if with_q_valid:
        assert (it.numpy()[~q_valid] == 0).all() and np.isinf(dt.numpy()[~q_valid]).all()
    qv = kw.get("q_valid")
    perms = spatial_order(targs[2], tv, targs[3], targs[4], qv)
    live = live_tiles(*tile_boxes(targs[2], targs[3], targs[4], eps, tv, qv, *perms))
    assert 0.05 < float(live.float().mean()) < 0.95


def test_best_target_target_meta_layout():
    """K3's per-target record in its tile order: x, y, |t|^2 as int32 bits
    (-1 for invalid targets and the tail of the last 128-target tile), the
    original index as int32 bits; the order is a permutation with the valid
    targets first, in strips of y then x."""
    from ssrlcv_tpu_torch.matching.match_kernel import spatial_order, target_meta

    _, t, t_loc, p1, p2, t_valid, q_valid = _skip_case()
    tl, tv = torch.from_numpy(t_loc), torch.from_numpy(t_valid)
    qperm, tperm = spatial_order(tl, tv, torch.from_numpy(p1), torch.from_numpy(p2),
                                 torch.from_numpy(q_valid))
    for perm, n in ((qperm, len(p1)), (tperm, len(t))):
        assert perm.dtype == torch.int64 and sorted(perm.tolist()) == list(range(n))
    tp = tperm.numpy()
    assert t_valid[tp[:t_valid.sum()]].all()
    assert not q_valid[qperm.numpy()[q_valid.sum():]].any()  # q_valid false rows last
    meta = target_meta(torch.from_numpy(t), tl, tv, tperm)
    assert meta.shape == (1024, 4) and meta.dtype == torch.float32
    np.testing.assert_array_equal(meta[:1000, :2].numpy(), t_loc[tp])
    bits = meta.contiguous().view(torch.int32).numpy()
    expect = np.where(t_valid, (t.astype(np.int64) ** 2).sum(1), -1)[tp]
    np.testing.assert_array_equal(bits[:1000, 2], expect)
    np.testing.assert_array_equal(bits[:1000, 3], tp)
    assert (bits[1000:, 2] == -1).all()


def _features(rng, n, d=128, parent=0):
    from ssrlcv_tpu.core.types import FeatureSet

    fs = FeatureSet.empty(n, parent=parent)
    desc = rng.integers(0, 256, (n, d)).astype(np.uint8)
    return fs.replace(loc=jnp.asarray(rng.uniform(0, 1024, (n, 2)).astype(np.float32)),
                      descriptors=jnp.asarray(desc), mask=jnp.asarray(rng.random(n) > 0.1))


def _port(fs):
    from ssrlcv_tpu_torch.core.types import FeatureSet

    return FeatureSet(**{f: torch.from_numpy(np.array(getattr(fs, f)))
                         for f in ("loc", "sigma", "theta", "descriptors", "mask", "parent")})


def _assert_dm_equal(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("metric", ["l2sq", "sad"])
@pytest.mark.parametrize("index_only", [False, True])
def test_match_brute_force_matches_jax(metric, index_only):
    """Brute-force matching with seed distances: identical indices,
    distances and validity (squared L2 on 128-wide SIFT descriptors, SAD on
    81-wide windows); for squared L2 the K3 route (backend "kernel", its
    plain version on the CPU) gives the same on the query slots in the
    query's mask and (0, +inf) on the others, which are invalid either way
    (the seed distances of those slots are +inf too)."""
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.matching import match as J
    from ssrlcv_tpu_torch.matching import match as T

    rng = np.random.default_rng(21)
    d = 128 if metric == "l2sq" else 81
    q, t, seed = _features(rng, 200, d), _features(rng, 300, d, 1), _features(rng, 64, d)
    params = MatchParams(absolute_threshold=1e9, relative_threshold=0.99)
    jsd = J.seed_distances(q, seed, chunk=64, metric=metric)
    tsd = T.seed_distances(_port(q), _port(seed), chunk=64, metric=metric)
    qm = np.asarray(q.mask)
    np.testing.assert_array_equal(tsd.numpy()[qm], np.asarray(jsd)[qm])
    if metric == "l2sq":
        assert np.isinf(tsd.numpy()[~qm]).all() and (~qm).any()
    else:
        np.testing.assert_array_equal(tsd.numpy(), np.asarray(jsd))
    jd = J.match_brute_force(q, t, params, seed_dist=jsd, chunk=64, index_only=index_only,
                             metric=metric)
    td = T.match_brute_force(_port(q), _port(t), params, seed_dist=tsd, chunk=64,
                             index_only=index_only, metric=metric)
    _assert_dm_equal(td, jd)
    assert 0 < int(td.valid.sum()) < 200
    if metric == "l2sq":
        kd = T.match_brute_force(_port(q), _port(t), params, seed_dist=tsd, backend="kernel",
                                 index_only=index_only)
        np.testing.assert_array_equal(kd.valid.numpy(), np.asarray(jd.valid))
        np.testing.assert_array_equal(kd.target_idx.numpy()[qm], np.asarray(jd.target_idx)[qm])
        np.testing.assert_array_equal(kd.distance.numpy()[qm], np.asarray(jd.distance)[qm])
        assert (kd.target_idx.numpy()[~qm] == 0).all()
        assert np.isinf(kd.distance.numpy()[~qm]).all()


def test_threshold_semantics_match_jax():
    """The absolute bound, and the seeded bound squared (DMatch kernels) or
    not (index-only kernels), as tests/test_matching.py holds them."""
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.matching.match import _threshold as jthr
    from ssrlcv_tpu_torch.matching.match import _threshold as tthr

    idx = np.zeros(4, np.int32)
    dist = np.array([100.0, 39999.0, 40001.0, 500.0], np.float32)
    qmask = np.ones(4, bool)
    seed = np.array([1000.0, 200000.0, 200000.0, 1000.0], np.float32)
    params = MatchParams()
    for sd, squared in [(None, True), (seed, True), (seed, False)]:
        j = jthr(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(qmask), params,
                 None if sd is None else jnp.asarray(sd), squared=squared)
        t = tthr(torch.from_numpy(idx), torch.from_numpy(dist), torch.from_numpy(qmask),
                 params, None if sd is None else torch.from_numpy(sd), squared=squared)
        _assert_dm_equal(t, j)
    assert t.valid.tolist() == [True, True, False, True]  # unsquared: 0.5 <= 0.6


def _rig_cams():
    from test_torch_modules import _rig

    return _rig()[0]


def test_fundamental_and_fmatrix_matching_match_jax():
    """fundamental_from_cameras within float32 rounding (relative to the
    matrix's largest entry; it spans eight decades), and F-matrix
    constrained matching on the same F: identical results."""
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.core.camera_math import fundamental_from_cameras as jfun
    from ssrlcv_tpu.matching import match as J
    from ssrlcv_tpu_torch.core.camera_math import fundamental_from_cameras as tfun
    from ssrlcv_tpu_torch.matching import match as T

    cams = _rig_cams()
    foc_px = np.float32(np.asarray(cams.foc)[0] / np.asarray(cams.dpix)[0, 0])
    c = {k: np.asarray(getattr(cams, k)) for k in ("cam_rot", "cam_pos", "size")}
    jF = np.asarray(jfun(c["cam_rot"][0], c["cam_pos"][0], c["cam_rot"][1], c["cam_pos"][1],
                         jnp.float32(foc_px), c["size"][0]))
    tF = tfun(*(torch.from_numpy(np.array(a)) for a in (
        c["cam_rot"][0], c["cam_pos"][0], c["cam_rot"][1], c["cam_pos"][1], foc_px,
        c["size"][0]))).numpy()
    scale = np.abs(jF).max()
    np.testing.assert_allclose(tF / scale, jF / scale, rtol=0, atol=1e-5)

    rng = np.random.default_rng(5)
    q, t = _features(rng, 160), _features(rng, 400, parent=1)
    params = MatchParams(epsilon=40.0, absolute_threshold=1e9)
    jd = J.match_fmatrix_constrained(q, t, jnp.asarray(jF), params, chunk=64)
    td = T.match_fmatrix_constrained(_port(q), _port(t), torch.from_numpy(np.array(jF)), params,
                                     chunk=64)
    _assert_dm_equal(td, jd)
    assert 0 < int(td.valid.sum()) < 160


def test_match_utilities_match_jax():
    """validate, refine, sort (stable, with equal distances), the
    index-only form, raw matches and descriptor-carrying matches."""
    from ssrlcv_tpu.matching import match as J
    from ssrlcv_tpu_torch.matching import match as T

    rng = np.random.default_rng(9)
    n = 64
    q, t = _features(rng, n), _features(rng, 48, parent=1)
    arrays = (rng.integers(0, 48, n).astype(np.int32),
              rng.integers(0, 8, n).astype(np.float32) * 100.0,  # many equal distances
              rng.random(n) > 0.3)
    jd = J.DMatches(*(jnp.asarray(a) for a in arrays))
    td = T.DMatches(*(torch.from_numpy(a) for a in arrays))
    _assert_dm_equal(T.validate_matches(td), J.validate_matches(jd))
    _assert_dm_equal(T.refine_matches(td, 350.0), J.refine_matches(jd, 350.0))
    _assert_dm_equal(T.sort_matches(td), J.sort_matches(jd))
    _assert_dm_equal(T.match_index_only(td, 0, 1), J.match_index_only(jd, 0, 1))
    _assert_dm_equal(T.get_raw_matches(td, _port(q), _port(t), 0, 1),
                     J.get_raw_matches(jd, q, t, 0, 1))
    tf = T.get_feature_matches(td, _port(q), _port(t), 0, 1)
    jf = J.get_feature_matches(jd, q, t, 0, 1)
    assert tf._fields == jf._fields
    _assert_dm_equal(tf, jf)
    assert tf.descriptors.shape == (n, 2, 128)


@pytest.mark.parametrize("name", ["DMatches", "IndexPairs", "FeatureMatches"])
def test_match_tuples_mirror_jax(name):
    """The port's match tuples have the JAX tuples' field names in order, so
    a JAX value fetched with np.asarray becomes the port's and back."""
    from ssrlcv_tpu.matching import match as J
    from ssrlcv_tpu_torch.matching import match as T

    rng = np.random.default_rng(2)
    jt = getattr(J, name)
    assert getattr(T, name)._fields == jt._fields
    arrays = [rng.integers(0, 9, (5, 2)).astype(np.int32) for _ in jt._fields]
    tv = getattr(T, name)(*(torch.from_numpy(a) for a in arrays))
    for a, b in zip(tv, arrays):
        np.testing.assert_array_equal(a.numpy(), b)


def test_do_feature_matching_routes_modes_as_jax():
    """Stage 2 takes the double-constrained matcher for mode "double" and
    brute force for every other mode ("brute", "fmatrix"), as the JAX stage
    does; no mode raises."""
    from ssrlcv_tpu.config import MatchParams, PipelineConfig
    from ssrlcv_tpu_torch.matching import match as T
    from ssrlcv_tpu_torch.pipeline import stages as S

    rng = np.random.default_rng(4)
    f0, f1 = _port(_features(rng, 128)), _port(_features(rng, 128, parent=1))
    for mode in ("brute", "fmatrix"):
        cfg = PipelineConfig().replace(match=MatchParams(mode=mode, absolute_threshold=1e9))
        st = S.do_feature_matching(S.PipelineState(config=cfg, images=[None, None],
                                                   features=[f0, f1], device="cpu"))
        dm = T.match_brute_force(f0, f1, cfg.match)
        assert st.matches.count() == int(dm.valid.sum()) > 0
