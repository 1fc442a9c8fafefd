"""The benchmark's frozen operation and byte counts against the ones of
``chip_smoke.py`` they were copied from, on a small input."""

import math

import pytest
import torch

from benchmark import counts

chip_smoke = pytest.importorskip("chip_smoke")


def _keypoints(n=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(n, generator=g) * (2 * math.pi)
    sigma = 0.8 + 6.0 * torch.rand(n, generator=g)
    return theta, sigma


@pytest.mark.parametrize("pw", [0.5, 1.0, 2.0])
def test_k1_k2_samples_equal_chip_smoke(pw):
    theta, sigma = _keypoints()
    assert counts.k1_samples(sigma, pw, 1.5, 11) == chip_smoke._k1_samples(sigma, pw, 1.5, 11)
    assert (counts.k2_samples(theta, sigma, pw, 6.0, 24, chunk=64)
            == chip_smoke._k2_samples(theta, sigma, pw, 6.0, 24, chunk=64))


@pytest.mark.parametrize("constrained", [False, True])
def test_gated_pairs_equal_chip_smoke(constrained):
    g = torch.Generator().manual_seed(1)
    nq, nt = 200, 300
    t_loc = torch.rand(nt, 2, generator=g) * 256
    q_mask = torch.rand(nq, generator=g) > 0.2
    t_valid = torch.rand(nt, generator=g) > 0.1
    if constrained:
        p1 = torch.rand(nq, 2, generator=g) * 256
        p2 = p1 + torch.rand(nq, 2, generator=g) * 40
    else:
        p1 = p2 = torch.full((nq, 2), math.inf)
    args = (q_mask, t_valid, p1, p2, t_loc, 5.0)
    assert counts.gated_pairs(*args) == chip_smoke._gated_pairs(*args)


def test_bound_and_bytes_equal_chip_smoke():
    x, y = torch.zeros(10, 3), torch.zeros(7, dtype=torch.uint8)
    assert counts.nbytes(x, y) == chip_smoke._nbytes(x, y)
    for nb, ops, kind in ((1e9, 1e12, "fp32"), (1e6, 1e15, "int8"), (5e9, 1.0, "fp32")):
        ours, theirs = counts.bound(nb, ops, kind), chip_smoke.bound(nb, ops, kind)
        assert ours["bound_by"] == theirs["bound_by"]
        assert ours["bound_s"] * 1e3 == pytest.approx(theirs["bound_ms"], rel=1e-12)
    from ssrlcv_tpu_torch.bench import scene as program_scene

    assert (counts.H100_BYTES_PER_S, counts.H100_FP32_PER_S, counts.H100_INT8_PER_S) == (
        program_scene.H100_BYTES_PER_S, program_scene.H100_FP32_PER_S,
        program_scene.H100_INT8_PER_S)
