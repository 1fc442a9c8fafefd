"""The port's patch extraction (kernel K5's plain version) and the
use_patches route of orientation and descriptors against the JAX package,
on the CPU (the Pallas extractor runs in interpret mode, as the JAX
package's own tests run it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import _K, _WMAX, _orient_inputs, _patch_case, _plane

torch.set_num_threads(2)


def test_extract_patches_and_sampling_match_jax():
    """px, py, y0, x0 and the in-patch samples bit-identical to the JAX
    extract_patches + sample_in_patches, and the samples to indexing the
    plane (tests/test_patches.py's setup: 320 x 512, k = 37, near-edge
    keypoints, plus .5 coordinates for the half-to-even rounding)."""
    from ssrlcv_tpu.features import patches as J
    from ssrlcv_tpu_torch.features import patches as T

    gx, gy, loc = _patch_case()
    h, w = gx.shape
    jp = J.extract_patches(jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(loc), _WMAX,
                           interpret=True)
    tp = T.extract_patches(torch.from_numpy(gx), torch.from_numpy(gy), torch.from_numpy(loc),
                           _WMAX)
    assert tp[0].shape == (loc.shape[0], T.patch_rows(_WMAX), T.LW)
    assert T.patch_rows(_WMAX) == J.patch_rows(_WMAX) and T.LW == J.LW
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tp[2].dtype == torch.int32 and tp[3].dtype == torch.int32

    offs = np.arange(2 * _WMAX + 1) - _WMAX
    cx = np.round(loc[:, 0]).astype(np.int32)
    cy = np.round(loc[:, 1]).astype(np.int32)
    yi = np.clip(cy[:, None, None] + offs[None, :, None], 0, h - 1)
    xi = np.clip(cx[:, None, None] + offs[None, None, :], 0, w - 1)
    js = J.sample_in_patches(*jp, jnp.asarray(yi), jnp.asarray(xi))
    ts = T.sample_in_patches(*tp, torch.from_numpy(yi), torch.from_numpy(xi))
    yb, xb = np.broadcast_arrays(yi, xi)
    for a, b, plane in zip(ts, js, (gx, gy)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), plane[yb, xb])


def test_patches_supported_matches_jax():
    from ssrlcv_tpu.features import patches as J
    from ssrlcv_tpu_torch.features import patches as T

    for h, w, wm in [(40, 256, 12), (39, 256, 12), (320, 255, 12), (2048, 2048, 63),
                     (2048, 2048, 64), (72, 512, 29)]:
        assert T.patches_supported(h, w, wm) == J.patches_supported(h, w, wm), (h, w, wm)
    with pytest.raises(ValueError, match="plane of at least"):
        T.extract_patches(torch.zeros(32, 512), torch.zeros(32, 512), torch.zeros(4, 2), 12)


def test_orientation_patch_route_matches_jax_and_k1_route():
    """_histogram_for_keypoints with use_patches against the JAX
    use_patches route (interpret mode) at rtol 2e-5 / atol 1e-6 (float32
    sums over up to 625 samples in another order), and bit-identical to the
    port's K1 route: the same histogram body over the same samples.  Then
    compute_orientations with use_patches equals the K1 route's."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.orientation import _histogram_for_keypoints as jhist
    from ssrlcv_tpu_torch.features.detector import SSKeyPoints
    from ssrlcv_tpu_torch.features.orientation import _histogram_for_keypoints as thist
    from ssrlcv_tpu_torch.features.orientation import compute_orientations

    params = SIFTParams()
    lam = params.orientation_contrib_width
    grads, loc, sigma = _orient_inputs()
    mask = np.ones(_K, bool)
    mask[3] = False
    ref, ref_valid = jhist(jnp.asarray(grads[1]), jnp.ones((_K,), jnp.int32), jnp.asarray(loc),
                           jnp.asarray(sigma), jnp.asarray(mask), 1.0, lam, _WMAX,
                           use_patches=True)
    gx, gy = _plane(grads)
    tl, ts, tm = (torch.from_numpy(a) for a in (loc, sigma, mask))
    got, valid = thist(gx, gy, tl, ts, tm, 1.0, lam, _WMAX, use_patches=True)
    m = mask
    np.testing.assert_allclose(got.numpy()[m], np.asarray(ref)[m], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    k1, k1_valid = thist(gx, gy, tl, ts, tm, 1.0, lam, _WMAX)
    assert torch.equal(got, k1) and torch.equal(valid, k1_valid)

    kps = SSKeyPoints(blur=torch.ones(_K, dtype=torch.int32), loc=tl,
                      intensity=torch.zeros(_K), sigma=ts, theta=torch.zeros(_K), mask=tm)
    a = compute_orientations(gx, gy, kps, 1.0, params, _WMAX, use_patches=True, w_patch=14)
    b = compute_orientations(gx, gy, kps, 1.0, params, _WMAX)
    assert torch.equal(a.mask, b.mask) and torch.equal(a.theta, b.theta)


def test_descriptor_patch_route_matches_jax_and_k2_route():
    """fill_descriptors with use_patches against the JAX use_patches route
    (interpret mode): uint8 within 1, because the histogram sums run in
    another order (torch's batched product vs XLA's dot) and a value on a
    .5 quantisation boundary may round either way; and bit-identical to the
    port's K2 route (the same body over the same samples)."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.descriptor import fill_descriptors as jfill
    from ssrlcv_tpu.features.detector import SSKeyPoints as JKP
    from ssrlcv_tpu_torch.features.descriptor import fill_descriptors as tfill
    from ssrlcv_tpu_torch.features.detector import SSKeyPoints as TKP

    rng = np.random.default_rng(7)
    params = SIFTParams()
    grads, _, _ = _orient_inputs()
    loc = rng.uniform(_WMAX + 4, 300, (_K, 2)).astype(np.float32)
    sigma = rng.uniform(1.0, 2.0, (_K,)).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, (_K,)).astype(np.float32)
    arrays = dict(blur=np.ones(_K, np.int32), loc=loc, intensity=np.zeros(_K, np.float32),
                  sigma=sigma, theta=theta, mask=np.ones(_K, bool))
    ref, ref_loc = jfill(jnp.asarray(grads[1]), JKP(**{k: jnp.asarray(v) for k, v in
                                                       arrays.items()}),
                         1.0, params, w_max=_WMAX, use_patches=True)
    gx, gy = _plane(grads)
    kps = TKP(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    got, got_loc = tfill(gx, gy, kps, 1.0, params, _WMAX, use_patches=True)
    diff = np.abs(got.numpy().astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_array_equal(got_loc.numpy(), np.asarray(ref_loc))
    k2, _ = tfill(gx, gy, kps, 1.0, params, _WMAX)
    assert torch.equal(got, k2)
