"""The port's dense SIFT and Window_NxN features against the JAX package,
on the CPU, at small sizes.

Same numpy-seeded images through ``ssrlcv_tpu.features.dense`` and
``ssrlcv_tpu_torch.features.dense``.  Dense keypoints are compared by slot:
(interior pixel, orientation rank), where the rank of a row is its place
among the rows of its pixel (both packages emit pixel-major, orientations in
descending magnitude).  The orientation field's 36 blurred bin planes are
bit-identical (the port emulates XLA's fused multiply-adds); the parabola
step ``off * pi/36 + centre`` is one fused multiply-add under XLA and two
roundings in the port, so a peak's angle may differ by 2 ulp (2e-6 rad) and
a descriptor by one count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

THETA_ULPS = 2e-6  # two float32 ulps of an angle in [4, 8)


def _texture(h=96, w=96, seed=0):
    """tests/test_dense.py's blocky texture."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8, w // 8)).astype(np.uint8)
    return np.kron(base, np.ones((8, 8), np.uint8))


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 255, (h, w)).astype(np.uint8)


IMAGES = {"noise_64x80": lambda: _noise(64, 80, 3), "texture_80x96": lambda: _texture(80, 96, 5)}


def _slots(loc, theta, desc, mask):
    """{(y, x, rank): (theta, descriptor)} of a dense feature set's rows."""
    loc, theta, desc = (np.asarray(a)[np.asarray(mask)] for a in (loc, theta, desc))
    out, seen = {}, {}
    for (x, y), t, d in zip(loc.tolist(), theta, desc):
        r = seen.get((y, x), 0)
        seen[(y, x)] = r + 1
        out[(y, x, r)] = (float(t), d.astype(np.int32))
    return out


def _fs_slots(fs):
    return _slots(fs.loc, fs.theta, fs.descriptors, fs.mask)


def _compare(a, b, min_common=0.995, max_desc=3, theta_tol=None):
    """Keypoint sets by slot agree on >= min_common of the larger; common
    descriptors within max_desc; common angles within theta_tol when given.
    Returns (common, max |descriptor diff|)."""
    common = set(a) & set(b)
    assert len(common) >= min_common * max(len(a), len(b)), (len(a), len(b), len(common))
    dmax = max(int(np.abs(a[k][1] - b[k][1]).max()) for k in common)
    assert dmax <= max_desc, dmax
    if theta_tol is not None:
        dth = np.array([abs(a[k][0] - b[k][0]) for k in common])
        assert (np.minimum(dth, 2 * np.pi - dth) <= theta_tol).all(), dth.max()
    return common, dmax


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_dense_orientation_field_matches_jax(image):
    """The 36-bin stencil field's peaks: the same oriented slots, angles
    within 2 ulp."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features import dense as J
    from ssrlcv_tpu.ops import image_ops as JO
    from ssrlcv_tpu_torch.features import dense as T
    from ssrlcv_tpu_torch.ops import image_ops as TO

    params = SIFTParams()
    img = IMAGES[image]()
    h, w = img.shape
    grads = JO.pixel_gradients(JO.normalize_minmax(JO.to_float(jnp.asarray(img))))
    jt, jo = (np.asarray(a) for a in J._dense_orientation_field(grads, params, 5, h, w))
    gx, gy = TO.pixel_gradients(TO.normalize_minmax(TO.to_float(torch.from_numpy(img))))
    tt, to = (a.numpy() for a in T._dense_orientation_field(gx, gy, params, 5))
    assert to.shape == jo.shape == ((h - 24) * (w - 24) * params.max_orientations,)
    np.testing.assert_array_equal(to, jo)
    assert to.sum() > 0.5 * (h - 24) * (w - 24)
    np.testing.assert_allclose(tt[to], jt[jo], rtol=0, atol=THETA_ULPS)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("image", sorted(IMAGES))
def test_dense_sift_matches_jax(image, fast):
    """generate_dense_sift, the fast path and the gather oracle each against
    its JAX twin: slot sets >= 99.5 % (here identical), the same locations
    in the same order, descriptors within 3 (the JAX package's dense
    tolerance), angles within 2 ulp; masked rows as FeatureSet.empty."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.dense import generate_dense_sift as jgen
    from ssrlcv_tpu_torch.features.dense import generate_dense_sift as tgen

    params = SIFTParams()
    img = IMAGES[image]()
    jf = jgen(img, params, image_id=3, fast=fast)
    tf = tgen(img, params, image_id=3, fast=fast, device="cpu")
    n = tf.count()
    assert tf.capacity == max(-(-n // 128) * 128, 128)
    jm = np.asarray(jf.mask)
    np.testing.assert_array_equal(tf.loc.numpy()[:n], np.asarray(jf.loc)[jm])
    assert tf.mask[:n].all() and not tf.mask[n:].any()
    assert (tf.loc[n:] == -1).all() and (tf.descriptors[n:] == 0).all()
    assert (tf.parent == 3).all() and (tf.sigma[:n] == 1).all()
    _compare(_fs_slots(tf), _fs_slots(jf), theta_tol=THETA_ULPS)


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_dense_sift_fast_matches_gather(image):
    """Within the port, the stencil field against the gather oracle (K1's
    plain version): slot sets >= 99.5 %, descriptors within 3, and 99.9 %
    of the common angles within 1e-3 (tests/test_dense.py's tolerance for
    the same pair in the JAX package)."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu_torch.features.dense import generate_dense_sift

    img = IMAGES[image]()
    fast = _fs_slots(generate_dense_sift(img, SIFTParams(), fast=True, device="cpu"))
    ref = _fs_slots(generate_dense_sift(img, SIFTParams(), fast=False, device="cpu"))
    common, _ = _compare(fast, ref)
    dth = np.array([abs(fast[k][0] - ref[k][0]) for k in common])
    assert (np.minimum(dth, 2 * np.pi - dth) < 1e-3).mean() > 0.999


def test_dense_sift_refuses_a_border_inside_the_window():
    """The fast path needs params.border > the orientation window (5): at
    border 5 its field would read the convolutions' border mode."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu_torch.features.dense import generate_dense_sift

    img = _texture(48, 48)
    with pytest.raises(ValueError, match="border"):
        generate_dense_sift(img, SIFTParams(border=5), device="cpu")
    assert generate_dense_sift(img, SIFTParams(border=6), device="cpu").count() > 0


def test_dense_sift_defaults_to_the_card(monkeypatch):
    """Without a device, numpy pixels go to cuda:0, which raises here."""
    from ssrlcv_tpu_torch.features.dense import generate_dense_sift, generate_window_features

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (generate_dense_sift, generate_window_features):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(_texture(32, 32))


@pytest.mark.parametrize("window", [3, 9, 15, 25, 31])
def test_window_features_match_jax(window):
    """Window_NxN features bit-identical to the JAX package's."""
    from ssrlcv_tpu.features.dense import generate_window_features as jgen
    from ssrlcv_tpu_torch.features.dense import generate_window_features as tgen

    img = _noise(40, 52, window)
    j = jgen(img, window=window)
    t = tgen(img, window=window, device="cpu")
    assert t.window == j.window == window and t.capacity == (40 - window + 1) * (52 - window + 1)
    np.testing.assert_array_equal(t.loc.numpy(), np.asarray(j.loc))
    np.testing.assert_array_equal(t.descriptors.numpy(), np.asarray(j.descriptors))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    with pytest.raises(ValueError):
        tgen(img, window=5, device="cpu")


def test_sad_best_target_matches_jax():
    """sad_best_target's idx and dist identical to JAX's, with invalid
    targets, duplicated targets (the first wins) and a shifted crop (dx == 5
    on > 80 % of the inner rows, median distance 0, as tests/test_dense.py)."""
    from ssrlcv_tpu.features.dense import sad_best_target as jsad
    from ssrlcv_tpu_torch.features.dense import generate_window_features, sad_best_target

    img = _texture(48, 48, seed=1)
    q = generate_window_features(img, window=9, device="cpu")
    t = generate_window_features(np.roll(img, 5, axis=1), window=9, device="cpu")
    valid = t.mask.clone()
    valid[::7] = False
    for tv in (t.mask, valid):
        idx, dist = sad_best_target(q.descriptors, t.descriptors, tv, chunk=100)
        ji, jd = jsad(jnp.asarray(q.descriptors.numpy()), jnp.asarray(t.descriptors.numpy()),
                      jnp.asarray(tv.numpy()))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
    idx, dist = sad_best_target(q.descriptors, t.descriptors, t.mask)
    qloc, tloc = q.loc.numpy(), t.loc.numpy()[idx.numpy()]
    inner = (qloc[:, 0] > 8) & (qloc[:, 0] < 30)
    assert (tloc[inner, 0] - qloc[inner, 0] == 5).mean() > 0.8
    assert float(np.median(dist.numpy()[inner])) == 0.0
    # a blocky texture has many equal patches: the lowest target index wins
    d = (q.descriptors[:, None, :].int() - t.descriptors[None, :, :].int()).abs().sum(-1)
    first = torch.argmax((d == d.min(dim=1, keepdim=True).values).int(), dim=1)
    np.testing.assert_array_equal(idx.numpy(), first.numpy())


def test_sad_match_double_constrained_matches_jax():
    """Window_NxN features (9x9) through the seeded, epipolar-gated matcher
    with metric="sad", on the inputs of tests/test_matching.py's
    scalar-oracle test (rng 17: 96 queries, 160 targets, 64 seeds, masks)
    placed on a 256^2 image pair of the synthetic scene, epsilon 25: the
    port's chunked path (backend "auto" and "chunked" on the CPU) identical
    to JAX backend="xla" in idx, distance and validity on every row;
    "kernel" (K3) refuses 81-wide descriptors."""
    from ssrlcv_tpu.config import MatchParams
    from ssrlcv_tpu.features.dense import WindowFeatures as JW
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu.matching import match as JM
    from ssrlcv_tpu_torch.core.types import Cameras
    from ssrlcv_tpu_torch.features.dense import WindowFeatures as TW
    from ssrlcv_tpu_torch.matching import match as TM
    from ssrlcv_tpu_torch.synthetic import make_scene

    rng = np.random.default_rng(17)
    nq, nt, d = 96, 160, 81

    def arrays(n, p_valid):
        return (rng.uniform(0, 256, (n, 2)).astype(np.float32),
                rng.integers(0, 256, (n, d)).astype(np.uint8), rng.random(n) > p_valid)

    qa, ta = arrays(nq, 0.1), arrays(nt, 0.1)
    sa = (rng.uniform(0, 256, (64, 2)).astype(np.float32),
          rng.integers(0, 256, (64, d)).astype(np.uint8), np.ones(64, bool))
    jw = [JW(loc=jnp.asarray(a[0]), descriptors=jnp.asarray(a[1]), mask=jnp.asarray(a[2]),
             window=9) for a in (qa, ta, sa)]
    tw = [TW(loc=torch.from_numpy(a[0]), descriptors=torch.from_numpy(a[1]),
             mask=torch.from_numpy(a[2]), window=9) for a in (qa, ta, sa)]
    jc = cameras_from_refimages(make_scene(seed=1, size=256).images)
    tc = Cameras.from_numpy(**{f.name: np.asarray(getattr(jc, f.name))
                               for f in dataclasses.fields(jc)})
    # relative threshold 1 (not 0.9): random descriptors sit at similar
    # distances, and 0.81 of the seed distance would keep no match
    params = MatchParams(epsilon=25.0, delta=5.0, absolute_threshold=1e9, relative_threshold=1.0)

    jsd = JM.seed_distances(jw[0], jw[2], metric="sad")
    tsd = TM.seed_distances(tw[0], tw[2], metric="sad")
    np.testing.assert_array_equal(tsd.numpy(), np.asarray(jsd))
    j = JM.match_double_constrained(jw[0], jw[1], jc, 0, 1, params, seed_dist=jsd, metric="sad",
                                    backend="xla")
    for backend in ("auto", "chunked"):
        t = TM.match_double_constrained(tw[0], tw[1], tc, 0, 1, params, seed_dist=tsd,
                                        metric="sad", backend=backend, chunk=40)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_array_equal(t.target_idx.numpy(), np.asarray(j.target_idx))
        np.testing.assert_array_equal(t.distance.numpy(), np.asarray(j.distance))
        assert 0 < t.valid.sum() < nq
    # the gate changed the answer: the unconstrained best differs on most rows
    brute = TM.match_brute_force(tw[0], tw[1], params, metric="sad")
    assert (brute.target_idx != t.target_idx).float().mean() > 0.5
    with pytest.raises(ValueError):
        TM.match_double_constrained(tw[0], tw[1], tc, 0, 1, params, metric="sad",
                                    backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        TM.match_double_constrained(tw[0], tw[1], tc, 0, 1, params, backend="xla")
