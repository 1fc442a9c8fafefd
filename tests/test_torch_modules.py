"""The port's modules against their JAX twins, on the CPU, at small sizes.

Same numpy-seeded inputs through ssrlcv_tpu and ssrlcv_tpu_torch; the
tolerances are those the JAX package holds itself to: keypoints within
1e-3 px with sets agreeing >= 99.5 %, clouds within 1e-3 km, BA final error
within relative 1e-3.  Where the port reproduces XLA's rounding (the blur's
fused multiply-adds, the bin's summation order) the test is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _image(seed=0, h=128, w=128):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.uint8)


@pytest.mark.parametrize("op", ["to_bw", "normalize_minmax", "bin2x", "upsample2x",
                                "convolve_separable_symmetric", "pixel_gradients",
                                "convolve_separable_symmetric.half_ge_n"])
def test_image_ops_match_jax(op):
    from ssrlcv_tpu.ops import image_ops as J
    from ssrlcv_tpu_torch.ops import image_ops as T

    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    if op == "to_bw":
        rgb = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
        np.testing.assert_array_equal(T.to_bw(_t(rgb)).numpy(), np.asarray(J.to_bw(rgb)))
        return
    if op == "convolve_separable_symmetric.half_ge_n":
        # 65 taps (half 32) over 16^2, the smallest octave of a 128^2 scale
        # space, and over 12 x 20, where half > 2n along H: the border wraps
        # more than once
        taps = J.gaussian_kernel_1d(8.0, 1.0)
        assert len(taps) == 65
        for shape in ((16, 16), (12, 20)):
            small = rng.uniform(0, 255, shape).astype(np.float32)
            ref = jax.jit(lambda x: J.convolve_separable_symmetric(x, taps))(small)
            got = T.convolve_separable_symmetric(_t(small), taps)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
        return
    if op == "convolve_separable_symmetric":
        taps = J.gaussian_kernel_1d(1.6, 0.5)
        np.testing.assert_array_equal(T.gaussian_kernel_1d(1.6, 0.5), taps)
        ref = jax.jit(lambda x: J.convolve_separable_symmetric(x, taps))(img)
        got = T.convolve_separable_symmetric(_t(img), taps)
        # one fused multiply-add per tap, as XLA compiles it; the float64
        # emulation may round differently only on an exact float32 tie
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
        return
    ref = jax.jit(getattr(J, op))(img)
    got = getattr(T, op)(_t(img))
    if op == "pixel_gradients":
        got = torch.stack(got, dim=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scale_space_matches_jax():
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features import scale_space as J
    from ssrlcv_tpu_torch.features import scale_space as T

    params = SIFTParams()
    img = _image()
    jo = J.build_scale_space(img, params, *img.shape)
    to = T.build_scale_space(_t(img), params, *img.shape)
    assert len(jo) == len(to)
    for o, (a, b) in enumerate(zip(jo, to)):
        assert a.sigmas == pytest.approx(b.sigmas) and float(a.pixel_width) == b.pixel_width
        # octave 0 (upsample + blur chain) is exact; later octaves differ by
        # float32 rounding because XLA fuses each octave's seeding 2x bin into
        # its first blur, and min-max normalisation of the small octaves
        # magnifies that (DoG values are ~0.1; the extrema threshold 0.008)
        atol = 0.0 if o == 0 else 1e-3
        np.testing.assert_allclose(b.dog_raw.numpy(), np.asarray(a.dog_raw), rtol=0, atol=atol)
        np.testing.assert_allclose(b.dog_norm.numpy(), np.asarray(a.dog_norm), rtol=0,
                                   atol=10 * atol)


def test_detector_matches_jax():
    """find_keypoints_octave + check_descriptor_border on identical DoG
    stacks: the same keypoints, in the same order, within 1e-3 px."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features import detector as J
    from ssrlcv_tpu.features.scale_space import build_scale_space, octave_sigmas
    from ssrlcv_tpu_torch.features import detector as T

    params = SIFTParams()
    img = _image(seed=2, h=128, w=128)
    octave = build_scale_space(img, params, 128, 128)[0]
    sigmas = tuple(octave_sigmas(params, 0))[: params.blurs_per_octave - 1]
    raw, norm = np.asarray(octave.dog_raw), np.asarray(octave.dog_norm)
    cap = 4096
    jk = J.find_keypoints_octave(jnp.asarray(raw), jnp.asarray(norm), sigmas, params, cap)
    pw = float(octave.pixel_width)
    jk = J.check_descriptor_border(jk, raw.shape[1:], 6.0, pw)
    tk = T.find_keypoints_octave(_t(raw), _t(norm), sigmas, params, cap)
    tk = T.check_descriptor_border(tk, raw.shape[1:], 6.0, pw)

    jm, tm = np.asarray(jk.mask), tk.mask.numpy()
    assert jm.sum() > 100
    assert (jm == tm).mean() >= 0.995
    both = jm & tm
    np.testing.assert_allclose(tk.loc.numpy()[both], np.asarray(jk.loc)[both], atol=1e-3)
    np.testing.assert_array_equal(tk.blur.numpy()[both], np.asarray(jk.blur)[both])
    np.testing.assert_allclose(tk.sigma.numpy()[both], np.asarray(jk.sigma)[both], rtol=1e-5)


def test_orientation_peaks_and_epilogue_match_jax():
    """peaks_from_histograms (with equal-magnitude peaks: lowest bin first)
    and descriptor_epilogue on identical inputs."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.descriptor import descriptor_epilogue as jep
    from ssrlcv_tpu.features.orientation import peaks_from_histograms as jpk
    from ssrlcv_tpu_torch.features.descriptor import descriptor_epilogue as tep
    from ssrlcv_tpu_torch.features.orientation import peaks_from_histograms as tpk

    rng = np.random.default_rng(4)
    params = SIFTParams()
    hist = rng.uniform(0, 1, (64, 36)).astype(np.float32)
    hist[:8] = np.round(hist[:8] * 3) / 3  # many equal values -> tied peaks
    hist[8] = 0.0
    valid = rng.uniform(size=64) > 0.1
    jt, jo = jpk(jnp.asarray(hist), jnp.asarray(valid), params)
    tt, to = tpk(_t(hist), _t(valid), params)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tt.numpy()[to.numpy()], np.asarray(jt)[np.asarray(jo)], atol=1e-6)

    v = rng.uniform(0, 3, (64, 128)).astype(np.float32)
    v[:, ::7] *= 20  # entries above the 0.2 clamp
    np.testing.assert_array_equal(tep(_t(v), _t(valid)).numpy(),
                                  np.asarray(jep(jnp.asarray(v), jnp.asarray(valid))))


def _rig():
    """The JAX package's pose-test camera rig (tests/test_pose.py) and
    matches made by projecting points near the ground into both views, with
    pixel noise."""
    from ssrlcv_tpu.core import camera_math as cm
    from ssrlcv_tpu.core.types import Cameras

    rng = np.random.default_rng(0)
    foc, fov = 0.8593, 0.0418879
    dpix = float(cm.effective_dpix(jnp.float32(foc), jnp.float32(fov), jnp.int32(1024)))
    ecef = np.zeros(3, np.float32)
    cams = Cameras(
        cam_pos=jnp.asarray(np.array([[0.0, 0.0, 0.0], [-70.0, 3.0, 1.5]], np.float32)),
        cam_rot=jnp.asarray(np.array([[2.0568, 0.0222, -0.0420],
                                      [2.0539, -0.0593, 0.1125]], np.float32)),
        fov=jnp.full((2, 2), fov, jnp.float32), foc=jnp.full((2,), foc, jnp.float32),
        dpix=jnp.full((2, 2), dpix, jnp.float32),
        size=jnp.asarray(np.full((2, 2), 1024, np.int32)),
        ecef_offset=jnp.asarray(np.stack([ecef, ecef])),
        timestamp=jnp.zeros((2,), jnp.int32))
    n = 400
    loc0 = rng.uniform(200, 800, (n, 2)).astype(np.float32)
    vec, pnt = cm.pixel_to_ray(jnp.asarray(loc0), cams.cam_pos[0], cams.cam_rot[0],
                               cams.foc[0], cams.fov[0, 0], cams.size[0])
    world = np.asarray(pnt + rng.uniform(380, 420, (n, 1)).astype(np.float32) * vec)
    P1 = cm.projection_matrix(cams.cam_pos[1], cams.cam_rot[1], cams.foc[1], cams.dpix[1],
                              cams.size[1], cams.ecef_offset[1])
    proj = np.asarray(jnp.einsum("ij,nj->ni", P1, jnp.concatenate(
        [jnp.asarray(world), jnp.ones((n, 1))], 1)))
    loc1 = proj[:, :2] / proj[:, 2:3] + rng.normal(0, 0.5, (n, 2))
    loc1[[7, 123, 301]] += 40.0  # a few gross outliers for the filters
    kp = np.stack([loc0, loc1.astype(np.float32)], axis=1)
    mask = np.ones(n, bool)
    mask[-16:] = False  # padding tracks
    arrays = dict(kp_loc=kp, kp_parent=np.tile(np.array([0, 1], np.int32), (n, 1)),
                  num_views=np.full(n, 2, np.int32), mask=mask)
    return cams, arrays


def _port_cams(cams):
    from ssrlcv_tpu_torch.core.types import Cameras

    return Cameras.from_numpy(**{f.name: np.asarray(getattr(cams, f.name))
                                 for f in dataclasses.fields(cams)})


def test_camera_math_matches_jax():
    """Rotations, ray lifting, projection and the Earth-bounded epipolar
    segments, on the synthetic scene's orbital cameras."""
    from ssrlcv_tpu.core import camera_math as J
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.core import camera_math as T
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=1, size=64)
    cams = cameras_from_refimages(scene.images)
    c = {f.name: np.asarray(getattr(cams, f.name)) for f in dataclasses.fields(cams)}
    loc = np.random.default_rng(3).uniform(0, 64, (50, 2)).astype(np.float32)
    ang = np.random.default_rng(3).uniform(-3, 3, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(T.rotation_matrix(_t(ang)).numpy(),
                               np.asarray(J.rotation_matrix(ang)), atol=1e-6)
    jv, jp = J.pixel_to_ray(loc, c["cam_pos"][1], c["cam_rot"][1], c["foc"][1],
                            c["fov"][1, 0], c["size"][1])
    tv, tp = T.pixel_to_ray(_t(loc), _t(c["cam_pos"][1]), _t(c["cam_rot"][1]), _t(c["foc"][1]),
                            _t(c["fov"][1, 0]), _t(c["size"][1]))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    keys = ("cam_pos", "cam_rot", "foc", "dpix", "size", "ecef_offset")
    jP = J.projection_matrix(*[c[k][1] for k in keys])
    tP = T.projection_matrix(*[_t(c[k][1]) for k in keys])
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5)
    j1, j2 = J.epipolar_segment_endpoints(loc, *[c[k][0] for k in keys], jP, 5.0)
    t1, t2 = T.epipolar_segment_endpoints(_t(loc), *[_t(c[k][0]) for k in keys],
                                          _t(np.asarray(jP)), 5.0)
    # float32 at Earth-radius scale (|c|^2 ~ 4.6e7 km^2 in the ray-sphere
    # quadratic): endpoints agree to a twentieth of a pixel
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=0, atol=0.05)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=0, atol=0.05)


def test_geometry_and_filters_match_jax():
    """Bundles, 2-view triangulation and both filters: clouds within
    1e-3 km, the linear-cutoff mask identical, the statistical filter's mask
    agreeing >= 99.5 %."""
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu.geometry import filters as JF
    from ssrlcv_tpu.geometry.bundles import generate_bundles as jgb
    from ssrlcv_tpu.geometry.triangulation import two_view_triangulate as jtri
    from ssrlcv_tpu_torch.core.types import MatchSet as TMS
    from ssrlcv_tpu_torch.geometry import filters as TF
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles as tgb
    from ssrlcv_tpu_torch.geometry.triangulation import two_view_triangulate as ttri

    cams, arrays = _rig()
    jms = JMS(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tms = TMS.from_numpy(**arrays)
    tc = _port_cams(cams)
    jb, tb = jgb(jms, cams), tgb(tms, tc)
    np.testing.assert_allclose(tb.vec.numpy(), np.asarray(jb.vec), atol=1e-6)
    jpc, jtot = jtri(jb)
    tpc, ttot = ttri(tb)
    m = arrays["mask"]
    np.testing.assert_array_equal(tpc.mask.numpy(), np.asarray(jpc.mask))
    assert np.abs(tpc.points.numpy()[m] - np.asarray(jpc.points)[m]).max() <= 1e-3
    assert float(ttot) == pytest.approx(float(jtot), rel=1e-4)

    cut = float(np.median(np.asarray(jpc.errors)[m]) * 4)  # a cutoff that bites
    j1, t1 = JF.linear_cutoff_filter(jms, cams, cut), TF.linear_cutoff_filter(tms, tc, cut)
    np.testing.assert_array_equal(t1.mask.numpy(), np.asarray(j1.mask))
    assert 0 < t1.mask.sum() < m.sum()
    j2 = JF.deterministic_statistical_filter(jms, cams, 3.0, 10)
    t2 = TF.deterministic_statistical_filter(tms, tc, 3.0, 10)
    assert (t2.mask.numpy() == np.asarray(j2.mask)).mean() >= 0.995
    assert 0 < t2.mask.sum() < m.sum()


def test_bundle_adjust_lm_matches_jax():
    """One 10-iteration LM run from a perturbed camera 1 on identical
    inputs: initial and final error within relative 1e-3 (the linear error
    is a float32 difference of ~400 km ray points, summed in another
    order)."""
    from ssrlcv_tpu.ba.two_view import bundle_adjust_two_view as jba
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust_two_view as tba
    from ssrlcv_tpu_torch.core.types import MatchSet as TMS

    cams, arrays = _rig()
    arrays["mask"][[7, 123, 301]] = False  # drop the outliers
    cams = cams.replace(cam_rot=cams.cam_rot.at[1, 1].add(2e-4))
    jr = jba(JMS(**{k: jnp.asarray(v) for k, v in arrays.items()}), cams, iterations=10,
             mode="lm")
    tr = tba(TMS.from_numpy(**arrays), _port_cams(cams), iterations=10, mode="lm")
    assert float(tr.initial_error) == pytest.approx(float(jr.initial_error), rel=1e-3)
    assert float(tr.final_error) < float(tr.initial_error)
    assert float(tr.final_error) == pytest.approx(float(jr.final_error), rel=1e-3)
    np.testing.assert_array_equal(tr.cameras.cam_pos.numpy()[0], np.asarray(cams.cam_pos)[0])
    with pytest.raises(ValueError):
        tba(TMS.from_numpy(**arrays), _port_cams(cams), mode="gauss")


@pytest.mark.parametrize("mode", ["newton", "reference"])
def test_bundle_adjust_modes_match_jax(mode):
    """The other two modes from the same perturbed camera 1.  "newton":
    initial and final error within relative 1e-3 of JAX's, final below
    initial, the error history likewise.  "reference": no update at all,
    initial == final, a flat history, and the cloud equal to
    two_view_triangulate's on the input cameras."""
    from ssrlcv_tpu.ba.two_view import bundle_adjust_two_view as jba
    from ssrlcv_tpu.config import BAParams
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust
    from ssrlcv_tpu_torch.core.types import MatchSet as TMS
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import two_view_triangulate

    cams, arrays = _rig()
    arrays["mask"][[7, 123, 301]] = False
    cams = cams.replace(cam_rot=cams.cam_rot.at[1, 1].add(2e-4))
    params = BAParams(iterations=6)
    jr = jba(JMS(**{k: jnp.asarray(v) for k, v in arrays.items()}), cams,
             iterations=params.iterations, initial_alpha=params.initial_alpha,
             svd_rcond=params.svd_rcond, mode=mode)
    tms, tc = TMS.from_numpy(**arrays), _port_cams(cams)
    tr = bundle_adjust(tms, tc, params, mode=mode)
    assert float(tr.initial_error) == pytest.approx(float(jr.initial_error), rel=1e-3)
    assert float(tr.final_error) == pytest.approx(float(jr.final_error), rel=1e-3)
    np.testing.assert_allclose(tr.error_history.numpy(), np.asarray(jr.error_history), rtol=1e-3)
    np.testing.assert_array_equal(tr.cameras.cam_pos.numpy()[0], np.asarray(cams.cam_pos)[0])
    if mode == "newton":
        assert float(tr.final_error) < float(tr.initial_error)
    else:
        assert float(tr.final_error) == float(tr.initial_error)
        assert (tr.error_history == tr.initial_error).all()
        pc, _ = two_view_triangulate(generate_bundles(tms, tc))
        assert torch.equal(tr.cloud.points, pc.points) and torch.equal(tr.cloud.mask, pc.mask)
        assert torch.equal(tr.cameras.cam_rot, tc.cam_rot)
