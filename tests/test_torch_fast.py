"""The port's FAST detector, roadmap surface, ``scale_image`` and ``to_rgb``
against the JAX package, on the CPU, at small sizes.

FAST on integer-valued images with an integer threshold is exact in both
packages (its scores are sums of integers), so locations, scores and masks
are compared bit for bit, ties included: equal neighbours under
non-maximum suppression keep the one first in raster order, and equal
scores are listed in raster order (``lax.top_k``'s order; the port sorts
stably).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _squares():
    """Four identical bright squares on a dark background: every corner
    score occurs four times (ties across the image)."""
    img = np.zeros((72, 72), np.uint8)
    for y0 in (8, 40):
        for x0 in (8, 40):
            img[y0:y0 + 20, x0:x0 + 20] = 200
    return img


def _plateau():
    """A one-pixel bright dot: its eight neighbours and the dot tie under
    non-maximum suppression in places, and a bright 2x2 block whose four
    pixels score alike."""
    img = np.full((40, 48), 50, np.uint8)
    img[12, 12] = 250
    img[25:27, 30:32] = 250
    return img


def _noise(seed=0):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return np.clip(gaussian_filter(rng.uniform(0, 255, (80, 96)), 1.0) * 1.5 - 60, 0,
                   255).astype(np.uint8)


CASES = {"squares": (_squares, 30.0, 9, 64), "plateau": (_plateau, 20.0, 9, 32),
         "noise": (_noise, 20.0, 9, 256), "noise_arc12": (_noise, 10.0, 12, 4096),
         "noise_capacity_over_pixels": (lambda: _noise(1)[:20, :24], 15.0, 9, 1000)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_detect_fast_matches_jax(case):
    """detect_fast bit-identical to JAX's: locations, scores, mask."""
    from ssrlcv_tpu.features.fast import detect_fast as jfast
    from ssrlcv_tpu_torch.features.fast import detect_fast

    make, threshold, arc, cap = CASES[case]
    img = make()
    jl, js, jm = (np.asarray(a) for a in jfast(jnp.asarray(img, jnp.float32), threshold=threshold,
                                               arc_length=arc, capacity=cap))
    tl, ts, tm = (a.numpy() for a in detect_fast(img, threshold, arc, cap, device="cpu"))
    assert tl.shape == (cap, 2) and ts.shape == tm.shape == (cap,)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ts, js)
    assert tm.sum() > 0
    if case == "squares":
        # each corner score occurs four times, listed in raster order
        s = ts[tm]
        assert len(s) >= 16 and all((s == v).sum() % 4 == 0 for v in np.unique(s))


def test_detect_fast_flat_image_and_default_device(monkeypatch):
    """A flat image has no corners; without a device numpy input wants the
    card, which raises here."""
    from ssrlcv_tpu_torch.features.fast import detect_fast

    _, scores, mask = detect_fast(np.full((64, 64), 100, np.uint8), 20.0, capacity=64,
                                  device="cpu")
    assert int(mask.sum()) == 0 and (scores == 0).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_fast(np.full((16, 16), 1, np.uint8))


def test_roadmap_surface_matches_jax():
    """fast_feature_factory is detect_fast, surf_feature_factory raises,
    kdtree equals the JAX package's (a point is its own nearest)."""
    from ssrlcv_tpu.features import roadmap as J
    from ssrlcv_tpu_torch.features import roadmap as T
    from ssrlcv_tpu_torch.features.fast import detect_fast

    img = _squares()
    for a, b in zip(T.fast_feature_factory(img, 30.0, capacity=64, device="cpu"),
                    detect_fast(img, 30.0, capacity=64, device="cpu")):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        T.surf_feature_factory()
    pts = np.random.default_rng(1).uniform(0, 1, (50, 3))
    d, i = T.kdtree(pts, pts[:5], k=3)
    jd, ji = J.kdtree(pts, pts[:5], k=3)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    assert d.shape == (5, 3) and (i[:, 0] == np.arange(5)).all()


@pytest.mark.parametrize("out_shape", [(64, 48), (32, 24), (45, 61), (13, 7), (100, 77)])
def test_scale_image_matches_jax(out_shape):
    """scale_image bit-identical to JAX's; 2x equals upsample2x and 1x the
    input."""
    from ssrlcv_tpu.ops.image_ops import scale_image as jscale
    from ssrlcv_tpu_torch.ops.image_ops import scale_image, upsample2x

    img = np.random.default_rng(3).uniform(0, 255, (32, 24)).astype(np.float32)
    got = scale_image(torch.from_numpy(img), out_shape)
    assert got.shape == out_shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jscale(jnp.asarray(img), out_shape)))
    if out_shape == (64, 48):
        np.testing.assert_array_equal(got.numpy(), upsample2x(torch.from_numpy(img)).numpy())
    if out_shape == (32, 24):
        np.testing.assert_array_equal(got.numpy(), img)


def test_to_rgb_matches_jax():
    """to_rgb replicates a grayscale image into three channels and passes
    an (H, W, C) image through, as JAX's."""
    from ssrlcv_tpu.ops.image_ops import to_rgb as jrgb
    from ssrlcv_tpu_torch.ops.image_ops import to_rgb

    gray = np.random.default_rng(4).integers(0, 256, (5, 7)).astype(np.uint8)
    got = to_rgb(torch.from_numpy(gray))
    assert got.shape == (5, 7, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrgb(jnp.asarray(gray))))
    rgb = np.random.default_rng(5).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(to_rgb(torch.from_numpy(rgb)).numpy(), rgb)
