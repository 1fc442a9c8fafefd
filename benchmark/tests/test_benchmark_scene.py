"""The benchmark's device copy of the synthetic scene against the
program's generator, on the CPU at a small size."""

import numpy as np
import pytest
import torch

from benchmark import scene as S


@pytest.mark.parametrize("seed,views", [(0, 2), (7, 3), (2**31 + 5, 2), (12345678901, 3)])
def test_scene_equals_the_program_generator(seed, views):
    from ssrlcv_tpu_torch.synthetic import make_scene

    ours, theirs = S.make_scene(seed, 96, views, "cpu"), make_scene(seed, 96, views)
    for a, b in zip(ours.views + [ours.seed], theirs.images + [theirs.seed_image]):
        assert a.id == b.id and a.size == b.size
        for f in ("cam_pos", "cam_rot", "fov", "dpix", "ecef_offset"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.foc == b.foc
        assert np.array_equal(a.pixels, b.pixels)


def test_surface_distance_matches_the_program_scene():
    from ssrlcv_tpu_torch.synthetic import make_scene

    ours, theirs = S.make_scene(3, 64, 2, "cpu"), make_scene(3, 64)
    loc = np.array([[10.5, 20.25], [32.0, 32.0], [50.0, 3.5]])
    pts = theirs.ground_points(loc) + np.array([0.0, 0.0, 0.01])  # 10 m above
    got = ours.surface_distance_m(torch.as_tensor(pts)).numpy()
    assert np.allclose(got, theirs.surface_distance_m(pts), atol=1e-6)
