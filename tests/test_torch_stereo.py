"""The port's dense stereo (``ssrlcv_tpu_torch.geometry.stereo``) against
the JAX package, on the CPU, at small sizes.

The window costs are integer box sums below 2^24, exact in float32 in any
order, so the scanline search is bit-identical.  The epipolar search floors
-(a x + c) / b, where XLA fuses F's multiply-adds and the port rounds each
product: a target row may move by one where the quotient sits within an
ulp of an integer, so the epipolar variant is held to the share of pixels
that differ (stated below), not to identity.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

PARALLEL_F = np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)


def _pair(shift, h=48, w=80, seed=0):
    """A random uint8 image and its copy rolled ``shift`` px in x (a feature
    at query x appears at target x + shift)."""
    base = np.random.default_rng(seed).integers(0, 255, (h, w)).astype(np.uint8)
    return base, np.roll(base, shift, axis=1)


def _skewed_f(seed=1):
    """A non-pattern F whose epipolar lines are nearly horizontal (b ~ -1,
    small slopes), so the epipolar search finds a shifted copy."""
    rng = np.random.default_rng(seed)
    F = PARALLEL_F + rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
    F[2, 2] = 0.3
    return F.astype(np.float32)


@pytest.mark.parametrize("direction,shift", [("right", 7), ("left", -6), ("undefined", 3)])
def test_disparity_scan_matching_matches_jax(direction, shift):
    """The scanline search in each direction: disparity and validity
    identical to JAX's; the shift found on > 90 % of the valid pixels."""
    from ssrlcv_tpu.geometry.stereo import disparity_scan_matching as jscan
    from ssrlcv_tpu_torch.geometry.stereo import disparity_scan_matching as tscan

    q, t = _pair(shift)
    jd, jv = jscan(jnp.asarray(q), jnp.asarray(t), max_disparity=16, window=5,
                   direction=direction)
    td, tv = tscan(torch.from_numpy(q), torch.from_numpy(t), max_disparity=16, window=5,
                   direction=direction)
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (td.numpy()[tv.numpy()] == shift).mean() > 0.9


def test_disparity_matching_matches_jax():
    """The per-pixel epipolar search on a non-pattern F, at window 7 over
    12 disparities: validity identical, target x identical, target y
    identical on all but <= 0.5 % of the valid pixels and never more than
    one row apart (the floor of a quotient within an ulp of an integer)."""
    from ssrlcv_tpu.geometry.stereo import disparity_matching as jdm
    from ssrlcv_tpu_torch.geometry.stereo import disparity_matching as tdm

    q, t = _pair(4, h=40, w=64, seed=2)
    F = _skewed_f()
    jx, jy, jv = (np.asarray(a) for a in jdm(jnp.asarray(q), jnp.asarray(t), jnp.asarray(F),
                                             max_disparity=12, window=7))
    tx, ty, tv = (a.numpy() for a in tdm(torch.from_numpy(q), torch.from_numpy(t),
                                         torch.from_numpy(F), max_disparity=12, window=7))
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0.3 * tv.size
    np.testing.assert_array_equal(tx[tv], jx[tv])
    dy = np.abs(ty[tv].astype(np.int64) - jy[tv])
    assert dy.max() <= 1 and (dy != 0).mean() <= 0.005, (dy != 0).mean()


def test_generate_disparity_matches_dispatch_and_errors():
    """The parallel-F pattern goes to the scanline search, any other F to
    the epipolar one, each equal to JAX's matches; bad windows and a
    disparity wider than the image raise ValueError; without a device the
    entry point wants the card."""
    from ssrlcv_tpu.geometry import stereo as J
    from ssrlcv_tpu_torch.geometry import stereo as T

    assert T._is_parallel_f(PARALLEL_F) and J._is_parallel_f(PARALLEL_F)
    assert T._is_parallel_f(torch.from_numpy(PARALLEL_F))
    for F in (_skewed_f(), np.eye(3, dtype=np.float32), PARALLEL_F * 2):
        assert not T._is_parallel_f(F) and not J._is_parallel_f(F)
    q, t = _pair(5, h=40, w=64, seed=4)
    for F, tol in ((PARALLEL_F, 0), (_skewed_f(), 1)):
        j0, j1 = J.generate_disparity_matches(q, t, F, max_disparity=10, window=5)
        t0, t1 = T.generate_disparity_matches(q, t, F, max_disparity=10, window=5, device="cpu")
        assert t0.dtype == t1.dtype == torch.float32 and len(t0) > 100
        np.testing.assert_array_equal(t0.numpy(), j0)
        np.testing.assert_allclose(t1.numpy(), j1, rtol=0, atol=tol)
    for window in (0, 4, 33):
        with pytest.raises(ValueError, match="window"):
            T.generate_disparity_matches(q, t, PARALLEL_F, window=window, device="cpu")
    with pytest.raises(ValueError, match="disparity"):
        T.generate_disparity_matches(q, t, PARALLEL_F, max_disparity=65, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.generate_disparity_matches(q, t, PARALLEL_F)
    finally:
        mp.undo()


def test_stereo_depth_formulas_match_jax():
    """compute_stereo_scale and compute_stereo_focal on random matches, and
    tests/test_aux.py's worked example."""
    from ssrlcv_tpu.geometry import stereo as J
    from ssrlcv_tpu_torch.geometry import stereo as T

    rng = np.random.default_rng(5)
    loc0 = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    loc1 = (loc0 + rng.uniform(-9, -1, (50, 2))).astype(np.float32)
    a, b = torch.from_numpy(loc0), torch.from_numpy(loc1)
    np.testing.assert_allclose(T.compute_stereo_scale(a, b, 8.0).numpy(),
                               np.asarray(J.compute_stereo_scale(loc0, loc1, 8.0)), rtol=1e-6)
    np.testing.assert_allclose(T.compute_stereo_focal(a, b, 2.0, 8.0, 0.5).numpy(),
                               np.asarray(J.compute_stereo_focal(loc0, loc1, 2.0, 8.0, 0.5)),
                               rtol=1e-6)
    one0, one1 = torch.tensor([[10.0, 5.0]]), torch.tensor([[6.0, 5.0]])
    np.testing.assert_array_equal(T.compute_stereo_scale(one0, one1, 8.0)[0].numpy(),
                                  [10.0, 5.0, 32.0])
    np.testing.assert_array_equal(T.compute_stereo_focal(one0, one1, 2.0, 8.0)[0].numpy(),
                                  [6.0, 5.0, 4.0])


def test_heat_map_matches_jax():
    """heat_map identical to JAX's over [0, 1], with its end points."""
    from ssrlcv_tpu.geometry.stereo import heat_map as jheat
    from ssrlcv_tpu_torch.geometry.stereo import heat_map

    v = np.concatenate([np.linspace(0, 1, 257), [0.5, 0.25]]).astype(np.float32)
    np.testing.assert_array_equal(heat_map(v), jheat(v))
    rgb = heat_map(np.array([0.0, 0.5, 1.0]))
    np.testing.assert_array_equal(rgb[0], [255, 0, 0])
    np.testing.assert_array_equal(rgb[2], [0, 0, 255])
    assert rgb[1][1] == 255


@pytest.mark.parametrize("radius", [0, 2])
def test_write_disparity_image_round_trip(tmp_path, radius):
    """Depth points written as a heat-map PNG by the port and by the JAX
    package read back identical, equal to heat_map of the normalised depth;
    ".png" is appended when missing."""
    from ssrlcv_tpu.geometry.stereo import write_disparity_image as jwrite
    from ssrlcv_tpu_torch.geometry.stereo import heat_map, write_disparity_image
    from ssrlcv_tpu_torch.io.images import read_image

    q, t = _pair(6, h=32, w=48, seed=6)
    from ssrlcv_tpu_torch.geometry.stereo import compute_stereo_scale, generate_disparity_matches

    loc0, loc1 = generate_disparity_matches(q, t, PARALLEL_F, max_disparity=12, window=5,
                                            device="cpu")
    pts = compute_stereo_scale(loc0, loc1)
    path = write_disparity_image(pts, str(tmp_path / "disp"), interpolation_radius=radius)
    assert path.endswith("disp.png") and os.path.exists(path)
    jpath = jwrite(pts.numpy(), str(tmp_path / "jax.png"), interpolation_radius=radius)
    got = read_image(path)
    np.testing.assert_array_equal(got, read_image(jpath))
    p = pts.numpy()
    assert got.shape == (int(p[:, 1].max()) + 1, int(p[:, 0].max()) + 1, 3)
    if radius == 0:
        depth = np.zeros(got.shape[:2], np.float32)
        depth[p[:, 1].astype(int), p[:, 0].astype(int)] = p[:, 2]
        z0, z1 = p[:, 2].min(), p[:, 2].max()
        np.testing.assert_array_equal(got, heat_map((depth - z0) / max(z1 - z0, 1e-12)))
