"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file imports
no jax, so it runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest`` skips tests/conftest.py, which sets jax up for the JAX
package's tests).  The input builders below are shared with
test_torch_kernels.py, which holds the same plain versions against the JAX
package on the CPU.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# orientation-histogram setup of tests/test_patches.py
_H, _W, _K, _WMAX = 320, 384, 24, 12


def _orient_inputs(seed=3):
    rng = np.random.default_rng(seed)
    grads = rng.standard_normal((3, _H, _W, 2)).astype(np.float32)
    loc = rng.uniform(_WMAX + 2, 300, (_K, 2)).astype(np.float32)
    sigma = rng.uniform(1.0, 2.5, (_K,)).astype(np.float32)
    return grads, loc, sigma


def _plane(grads, b=1):
    return (torch.from_numpy(np.ascontiguousarray(grads[b, ..., 0])),
            torch.from_numpy(np.ascontiguousarray(grads[b, ..., 1])))


def _match_case(seed=5):
    """Queries and targets with the cases K3 must get right: padded (invalid)
    targets, a duplicated target (a tie), a vertical segment, a query whose
    segment no target passes, and unconstrained rows (p1.x = +inf)."""
    rng = np.random.default_rng(seed)
    nq, nt = 300, 500
    t = rng.integers(0, 64, (nt, 128)).astype(np.uint8)
    q = rng.integers(0, 64, (nq, 128)).astype(np.uint8)
    q[:40] = t[rng.integers(0, nt, 40)]          # exact matches
    t[17] = t[9]                                  # a tie: lowest index must win
    q[260] = t[9]
    t_loc = rng.uniform(0, 256, (nt, 2)).astype(np.float32)
    t_valid = np.ones(nt, bool)
    t_valid[-37:] = False                         # capacity padding
    t_valid[rng.integers(0, nt - 37, 20)] = False
    t_valid[[9, 17]] = True
    p1 = rng.uniform(0, 256, (nq, 2)).astype(np.float32)
    p2 = rng.uniform(0, 256, (nq, 2)).astype(np.float32)
    p2[5, 0] = p1[5, 0]                           # vertical segment
    p1[6] = (5000.0, 5000.0)                      # no target passes
    p2[6] = (5100.0, 5200.0)
    unc = np.zeros(nq, bool)
    unc[250:] = True
    p1[unc] = np.inf
    p2[unc] = np.inf
    return q, t, t_loc, p1, p2, t_valid, unc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_cuda_orientation_matches_plain(cuda_device):
    """K1 within float32 summation-order rounding of its plain version
    (rtol 1e-4 / atol 1e-5), bitwise equal to itself, each launch counted."""
    from ssrlcv_tpu_torch.features.orient_kernel import (orientation_histograms,
                                                         orientation_histograms_plain)

    grads, loc, sigma = _orient_inputs()
    gx, gy = (t.to(cuda_device) for t in _plane(grads))
    loc_t, sig_t = torch.from_numpy(loc).to(cuda_device), torch.from_numpy(sigma).to(cuda_device)
    n = orientation_histograms.launches
    hk = orientation_histograms(gx, gy, loc_t, sig_t, 1.0, _WMAX, 1.5)
    assert orientation_histograms.launches == n + 1
    assert torch.equal(hk, orientation_histograms(gx, gy, loc_t, sig_t, 1.0, _WMAX, 1.5))
    hp = orientation_histograms_plain(gx, gy, loc_t, sig_t, 1.0, _WMAX, 1.5)
    torch.testing.assert_close(hk, hp, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_descriptor_matches_plain(cuda_device):
    """K2 within float32 rounding of its plain version (rtol 1e-4 /
    atol 1e-4 on raw histograms of magnitude ~10), bitwise equal to itself."""
    from ssrlcv_tpu_torch.features.desc_kernel import (descriptor_histograms,
                                                       descriptor_histograms_plain)

    grads, loc, sigma = _orient_inputs()
    gx, gy = (t.to(cuda_device) for t in _plane(grads))
    loc_t, sig_t = torch.from_numpy(loc).to(cuda_device), torch.from_numpy(sigma).to(cuda_device)
    theta = torch.linspace(0, 6.2, _K, device=cuda_device)
    n = descriptor_histograms.launches
    vk = descriptor_histograms(gx, gy, loc_t, theta, sig_t, 1.0, 6.0, _WMAX)
    assert descriptor_histograms.launches == n + 1
    assert torch.equal(vk, descriptor_histograms(gx, gy, loc_t, theta, sig_t, 1.0, 6.0, _WMAX))
    vp = descriptor_histograms_plain(gx, gy, loc_t, theta, sig_t, 1.0, 6.0, _WMAX)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_best_target_matches_plain(cuda_device):
    """K3 bit-identical to its plain version on padded targets, a tie, a
    vertical segment, a query no target passes and unconstrained rows; a
    misaligned descriptor operand is refused, not read."""
    from ssrlcv_tpu_torch.matching.match_kernel import best_target, best_target_plain

    q, t, t_loc, p1, p2, t_valid, _ = _match_case()
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, t, t_loc, p1, p2)]
    tv = torch.from_numpy(t_valid).to(cuda_device)
    n = best_target.launches
    ik, dk = best_target(*args, 25.0, tv)
    assert best_target.launches == n + 1
    ip, dp = best_target_plain(*args, 25.0, tv)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert int(ik[260]) == 9 and float(dk[6]) == float("inf")

    shifted = torch.zeros(q.size + 1, dtype=torch.uint8, device=cuda_device)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        best_target(shifted, *args[1:], 25.0, tv)


@pytest.mark.cuda
def test_cuda_slice_matches_cpu(cuda_device, tmp_path):
    """The 2-view slice on a 256x256 synthetic pair, on the card and on the
    CPU: feature counts within 0.5 %, points after filtering within 1 %, and
    every kernel of the path launched."""
    from ssrlcv_tpu.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.pipeline import stages as S
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=0, size=256)
    counters = (orientation_histograms, descriptor_histograms, best_target)
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        cfg = PipelineConfig(output_dir=str(tmp_path / dev.type)).replace(
            match=MatchParams(epsilon=25.0, delta=5.0), sift=SIFTParams(max_keypoints=4096))
        before = [fn.launches for fn in counters]
        seed = generate_features(scene.seed_image.pixels, cfg.sift, -1, device=dev)
        st = S.run_pipeline(S.PipelineState(config=cfg, images=scene.images,
                                            seed_features=seed), dev)
        runs[dev.type] = st
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        if dev.type == "cuda":
            assert all(n > 0 for n in launched) and launched[2] >= 2
        else:
            assert launched == [0, 0, 0]
    g, c = runs["cuda"], runs["cpu"]
    for fg, fc in zip(g.features, c.features):
        assert abs(fg.count() - fc.count()) <= 0.005 * fc.count()
    ng, nc = g.matches.count(), c.matches.count()
    assert nc > 200 and abs(ng - nc) <= 0.01 * nc
    assert g.ba_error[1] <= g.ba_error[0]
