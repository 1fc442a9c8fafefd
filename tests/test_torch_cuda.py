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


def _mma_case(seed=11):
    """K4's cases at Nq = 256, Nt = 1024: padded (invalid) targets, a
    duplicated target (a tie), a vertical segment, a query no target
    passes, unconstrained rows, and descriptors over the full uint8 range."""
    rng = np.random.default_rng(seed)
    nq, nt = 256, 1024
    t = rng.integers(0, 256, (nt, 128)).astype(np.uint8)
    q = rng.integers(0, 256, (nq, 128)).astype(np.uint8)
    q[:32] = t[rng.integers(0, nt, 32)]
    t[700] = t[300]                               # a tie: lowest index must win
    q[200] = t[300]
    t_loc = rng.uniform(0, 256, (nt, 2)).astype(np.float32)
    t_valid = np.ones(nt, bool)
    t_valid[-50:] = False                         # capacity padding
    t_valid[rng.integers(0, nt - 50, 40)] = False
    t_valid[[300, 700]] = True
    p1 = rng.uniform(0, 256, (nq, 2)).astype(np.float32)
    p2 = rng.uniform(0, 256, (nq, 2)).astype(np.float32)
    p2[5, 0] = p1[5, 0]                           # vertical segment
    p1[6] = (5000.0, 5000.0)                      # no target passes
    p2[6] = (5100.0, 5200.0)
    unc = np.zeros(nq, bool)
    unc[192:] = True
    p1[unc] = np.inf
    p2[unc] = np.inf
    return q, t, t_loc, p1, p2, t_valid, unc


def _patch_case(seed=0, h=320, w=512, k=37):
    """tests/test_patches.py's extraction setup: gradient planes and k
    keypoints, some near the edges, a few on exact .5 coordinates (rounded
    half to even)."""
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((h, w)).astype(np.float32)
    gy = rng.standard_normal((h, w)).astype(np.float32)
    loc = rng.uniform(2, min(h, w) - 3, (k, 2)).astype(np.float32)
    loc[:4] = [(2.5, 3.5), (w - 2.5, h - 3.5), (190.5, 64.5), (191.5, 63.5)]
    return gx, gy, loc


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


@pytest.mark.cuda
@pytest.mark.parametrize("w", [512, 510])
def test_cuda_extract_patches_matches_plain(cuda_device, w):
    """K5 bit-identical to its plain version in both copy forms (float4
    rows for W % 4 == 0, scalar otherwise), bitwise equal to itself."""
    from ssrlcv_tpu_torch.features.patches import extract_patches, extract_patches_plain

    gx, gy, loc = (torch.from_numpy(a).to(cuda_device) for a in _patch_case(w=w))
    n = extract_patches.launches
    got = extract_patches(gx, gy, loc, 12)
    assert extract_patches.launches == n + 1
    again = extract_patches(gx, gy, loc, 12)
    for a, b, c in zip(got, again, extract_patches_plain(gx, gy, loc, 12)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_best_target_mma_matches_plain(cuda_device):
    """K4 bit-identical to its plain version, and to K3 on every query with
    an admissible target; (0, 3.0e38) on the others."""
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.matching.match_mma import (NO_MATCH_DIST, best_target_mma,
                                                     best_target_mma_plain)

    q, t, t_loc, p1, p2, t_valid, _ = _mma_case()
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, t, t_loc, p1, p2)]
    tv = torch.from_numpy(t_valid).to(cuda_device)
    n = best_target_mma.launches
    ik, dk = best_target_mma(*args, 25.0, tv)
    assert best_target_mma.launches == n + 1
    ik2, dk2 = best_target_mma(*args, 25.0, tv)
    assert torch.equal(ik, ik2) and torch.equal(dk, dk2)
    ip, dp = best_target_mma_plain(*args, 25.0, tv)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    i3, d3 = best_target(*args, 25.0, tv)
    answered = torch.isfinite(d3)
    assert torch.equal(ik[answered], i3[answered]) and torch.equal(dk[answered], d3[answered])
    assert (ik[~answered] == 0).all() and (dk[~answered] == NO_MATCH_DIST).all()
    assert not bool(answered[6]) and int(ik[200]) == 300


@pytest.mark.cuda
def test_cuda_patch_row_sums_matches_plain(cuda_device):
    """K6 bit-identical to its plain version (the same row order, denormals
    kept), bitwise equal to itself."""
    from ssrlcv_tpu_torch.bench.gather_patches import (make_inputs, patch_row_sums,
                                                       patch_row_sums_plain)

    inp = make_inputs(seed=0, b=4, h=256, w=512, k=64, device=cuda_device)
    args = (inp["packed"], inp["bi"], inp["cy"], inp["cx"])
    n = patch_row_sums.launches
    got = patch_row_sums(*args)
    assert patch_row_sums.launches == n + 1
    assert torch.equal(got, patch_row_sums(*args))
    assert torch.equal(got, patch_row_sums_plain(*args))


@pytest.mark.cuda
def test_cuda_new_wrappers_refuse_bad_arguments(cuda_device):
    """On the card the K4, K5 and K6 wrappers raise on what their kernels
    do not take, and never fall back to the plain version."""
    from ssrlcv_tpu_torch.bench.gather_patches import patch_row_sums
    from ssrlcv_tpu_torch.features.patches import extract_patches
    from ssrlcv_tpu_torch.matching.match_mma import best_target_mma

    q, t, t_loc, p1, p2, t_valid, _ = _mma_case()
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, t, t_loc, p1, p2)]
    tv = torch.from_numpy(t_valid).to(cuda_device)
    shifted = torch.zeros(q.size + 1, dtype=torch.uint8, device=cuda_device)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        best_target_mma(shifted, *args[1:], 25.0, tv)
    g = torch.zeros((32, 512), device=cuda_device)
    with pytest.raises(ValueError, match="plane of at least"):
        extract_patches(g, g, torch.zeros((4, 2), device=cuda_device), 12)
    plane = torch.zeros((2, 40, 512), device=cuda_device)  # below SPA = 48 rows
    k = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at least"):
        patch_row_sums(plane, k, k, k, 33)
    with pytest.raises(TypeError):
        patch_row_sums(torch.zeros((2, 256, 512), device=cuda_device), k.long(), k, k, 33)
