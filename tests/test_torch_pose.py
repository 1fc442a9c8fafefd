"""The port's pose modules against their JAX twins, on the CPU.

The rig is the JAX package's pose-test rig (tests/test_pose.py): two
cameras over an Earth-like shell of points, with exact projected matches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pose import _synthetic_two_view

torch.set_num_threads(2)


def _port(value, cls):
    return cls.from_numpy(**{f.name: np.asarray(getattr(value, f.name))
                             for f in dataclasses.fields(value)})


def _port_cams(cams):
    from ssrlcv_tpu_torch.core.types import Cameras

    # the rig's timestamps are int32; the port's Cameras carry int64
    arrays = {f.name: np.asarray(getattr(cams, f.name)) for f in dataclasses.fields(cams)}
    arrays["timestamp"] = arrays["timestamp"].astype(np.int64)
    return Cameras.from_numpy(**arrays)


def test_axis_rotations_and_rodrigues_match_jax():
    from ssrlcv_tpu.core import camera_math as J
    from ssrlcv_tpu_torch.core import camera_math as T

    rng = np.random.default_rng(0)
    ang = rng.uniform(-1.4, 1.4, (64, 3)).astype(np.float32)
    R = np.array(J.rotation_matrix(ang))
    np.testing.assert_allclose(T.axis_rotations(torch.from_numpy(R)).numpy(),
                               np.asarray(J.axis_rotations(R)), atol=1e-6)
    np.testing.assert_allclose(T.axis_rotations(torch.from_numpy(R)).numpy(), ang, atol=1e-4)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    angle = rng.uniform(-3, 3, (64,)).astype(np.float32)
    np.testing.assert_allclose(
        T.rotate_point_arbitrary(*(torch.from_numpy(x) for x in (pts, axis, angle))).numpy(),
        np.asarray(J.rotate_point_arbitrary(pts, axis, angle)), atol=1e-6)
    a, b = rng.uniform(0, 100, (2, 64, 2)).astype(np.float32)
    p = rng.uniform(0, 100, (64, 2)).astype(np.float32)
    lines = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        T.point_segment_distance_2d(*(torch.from_numpy(x) for x in (p, a, b))).numpy(),
        np.asarray(J.point_segment_distance_2d(p, a, b)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        T.point_line_distance_2d(torch.from_numpy(p), torch.from_numpy(lines)).numpy(),
        np.asarray(J.point_line_distance_2d(p, lines)), rtol=1e-5)


@pytest.mark.parametrize("rot_noise", [0.0, 2e-4])
def test_refine_relative_pose_matches_jax(rot_noise):
    """LM from a perturbed camera 1: the refined cameras within 1e-5 rad
    and 1e-5 km of JAX's (a quarter pixel at 1024 px; the LM stops where no
    float32 candidate lowers the cost, and a tie between the packages' cost
    sums can end it one step apart), and the gap objective at least halved."""
    from ssrlcv_tpu.ba.two_view import _pack, make_objective
    from ssrlcv_tpu.config import PoseParams
    from ssrlcv_tpu.pose.lm import refine_relative_pose as jref
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.pose.lm import refine_relative_pose as tref

    ms, cams = _synthetic_two_view(rot_noise=rot_noise)
    bad = cams.replace(cam_rot=cams.cam_rot.at[1].add(jnp.array([2e-4, -1e-4, 1.5e-4])))
    jc = jref(ms, bad, PoseParams())
    tc = tref(_port(ms, MatchSet), _port_cams(bad), PoseParams())
    np.testing.assert_allclose(tc.cam_rot.numpy(), np.asarray(jc.cam_rot), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.cam_pos.numpy(), np.asarray(jc.cam_pos), rtol=0, atol=1e-5)
    obj = make_objective(ms, cams)
    fixed = bad.replace(cam_rot=jnp.asarray(tc.cam_rot.numpy()),
                        cam_pos=jnp.asarray(tc.cam_pos.numpy()))
    assert float(obj(_pack(fixed))) < 0.5 * float(obj(_pack(bad)))


@pytest.fixture(scope="module")
def ransac_case():
    """The JAX RANSAC test's rig with 20 % of the matches corrupted."""
    ms, cams = _synthetic_two_view(n=300, seed=3)
    rng = np.random.default_rng(4)
    loc = np.asarray(ms.kp_loc).copy()
    n = loc.shape[0]
    bad = rng.choice(n, n // 5, replace=False)
    loc[bad, 1] += rng.uniform(50, 200, (len(bad), 2))
    return ms.replace(kp_loc=jnp.asarray(loc)), cams, bad


def test_ransac_consensus_matches_jax(ransac_case):
    """The same 512 seven-match samples (the JAX sampler's indices) through
    both: identical inlier masks and counts.  The winning F differs (another
    nullspace basis can lead Newton to another root of the cubic), so R and t
    are held at 0.05 per entry (measured: 0.031 and 0.026); given JAX's own
    F the decomposition and cheirality vote agree to 1e-5."""
    from ssrlcv_tpu.pose.ransac import estimate_pose_ransac as jransac
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.pose import ransac as T

    ms, cams, bad = ransac_case
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jax.random.randint(key, (512, 7), 0, ms.kp_loc.shape[0]))
    j = jransac(ms, cams, key, num_candidates=512)
    tms, tc = _port(ms, MatchSet), _port_cams(cams)
    t = T.estimate_pose_from_indices(tms, tc, torch.from_numpy(idx).to(torch.int64))
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.num_inliers) == int(j.num_inliers) == 240
    assert not t.inliers.numpy()[bad].any()
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=0.05)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=0.05)
    R = t.R.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
    assert np.linalg.det(R) > 0.9

    q, tt = tms.kp_loc[:, 0], tms.kp_loc[:, 1]
    R2, t2 = T.decompose_essential(torch.from_numpy(np.array(j.F)), tc, q, tt,
                                   torch.from_numpy(np.array(j.inliers)))
    np.testing.assert_allclose(R2.numpy(), np.asarray(j.R), atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j.t), atol=1e-5)
    d = T.symmetric_epipolar_sq(torch.from_numpy(np.array(j.F))[None], q, tt)[0].numpy()
    np.testing.assert_array_equal(d < 0.25, np.asarray(j.inliers))


def test_ransac_generator_draws(ransac_case):
    """estimate_pose_ransac draws its samples from the generator: the same
    seed gives the same result, and the consensus rejects the corrupted
    matches."""
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.pose.ransac import estimate_pose_ransac

    ms, cams, bad = ransac_case
    tms, tc = _port(ms, MatchSet), _port_cams(cams)
    a, b = (estimate_pose_ransac(tms, tc, torch.Generator().manual_seed(5), num_candidates=256)
            for _ in range(2))
    assert torch.equal(a.inliers, b.inliers) and torch.equal(a.R, b.R)
    assert int(a.num_inliers) >= 0.75 * tms.capacity and not a.inliers.numpy()[bad].any()
