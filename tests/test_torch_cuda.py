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


def _mma_tile_case(seed=19):
    """K4's tile-schedule cases at Nq = 200 (not a multiple of 128), Nt =
    1024 with 700 admissible targets in [0, 512)^2, so that one tile of K3's
    order mixes admissible and inadmissible slots and the last two hold
    none.  Returns ((q, t, t_loc, p1, p2, t_valid), rows) where rows names
    the query of each case:
      tie_in_tile   equal distance to targets 50 and 600, neighbours (one
                    tile), 600 first in the spatial order;
      tie_across    equal distance to targets 20 and 400, far apart;
      far           all-255 query, only the all-0 target 800 in its gate
                    (d = 128 * 255^2 = 8,323,200);
      same_max      all-255 query, only the all-255 target 801 in its gate;
      invalid_only  only target 1000 (t_valid false, equal descriptor) in
                    its gate;
      nan_only      unconstrained, equal to target 802 (valid, x = NaN:
                    not admissible);
      nothing       no target in its gate."""
    rng = np.random.default_rng(seed)
    nq, nt = 200, 1024
    t = rng.integers(0, 256, (nt, 128)).astype(np.uint8)
    q = rng.integers(0, 256, (nq, 128)).astype(np.uint8)
    t_loc = rng.uniform(0, 512, (nt, 2)).astype(np.float32)
    t_valid = np.zeros(nt, bool)
    t_valid[:700] = True
    t_valid[rng.integers(0, 700, 30)] = False
    t_valid[[20, 50, 400, 600, 800, 801, 802]] = True
    q[:40] = t[rng.integers(0, 700, 40)]
    rows = {"tie_in_tile": 60, "tie_across": 61, "far": 62, "same_max": 63,
            "invalid_only": 64, "nan_only": 65, "nothing": 66}
    t[50] = t[600]
    t_loc[600], t_loc[50] = (100.0, 100.0), (100.5, 100.0)
    q[60] = t[600]
    t[400] = t[20]
    t_loc[20], t_loc[400] = (10.0, 10.0), (500.0, 500.0)
    q[61] = t[20]
    t[800], t_loc[800], q[62] = 0, (800.0, 800.0), 255
    t[801], t_loc[801], q[63] = 255, (50.0, 800.0), 255
    t_loc[1000], q[64] = (900.0, 900.0), t[1000]
    t_loc[802], q[65] = (np.nan, 700.0), t[802]
    p1 = rng.uniform(0, 512, (nq, 2)).astype(np.float32)
    p2 = rng.uniform(0, 512, (nq, 2)).astype(np.float32)
    for name, (x, y) in (("far", (800.0, 800.0)), ("same_max", (50.0, 800.0)),
                         ("invalid_only", (900.0, 900.0)), ("nothing", (5000.0, 5000.0))):
        p1[rows[name]], p2[rows[name]] = (x - 10.0, y), (x + 10.0, y)
    unc = np.zeros(nq, bool)
    unc[:30] = True
    unc[[60, 61, 65]] = True
    unc[150:170] = True
    p1[unc] = np.inf
    p2[unc] = np.inf
    return (q, t, t_loc, p1, p2, t_valid), rows


def _skip_case(seed=13, nq=400, nt=1000):
    """K3's tile-skip cases: queries and targets in y-major order (as SIFT
    emits them; K3 orders them itself), and per 16-row group of queries one
    kind of segment: short,
    steep (|slope| ~ 50), near-horizontal, vertical and zero-length
    segments, unconstrained rows, a query whose band meets no target, ties,
    invalid targets and a q_valid mask with a padding tail.  Returns
    (q, t, t_loc, p1, p2, t_valid, q_valid)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (nt, 128)).astype(np.uint8)
    q = rng.integers(0, 256, (nq, 128)).astype(np.uint8)
    t_loc = rng.uniform(0, 512, (nt, 2)).astype(np.float32)
    t_loc = t_loc[np.argsort(t_loc[:, 1], kind="stable")]
    q[:60] = t[rng.integers(0, nt, 60)]
    t[501] = t[500]                               # a tie: lowest index must win
    q[70] = t[500]
    t_valid = np.ones(nt, bool)
    t_valid[-40:] = False
    t_valid[rng.integers(0, nt - 40, 30)] = False
    t_valid[[500, 501]] = True
    c = rng.uniform(0, 512, (nq, 2)).astype(np.float32)
    c = c[np.argsort(c[:, 1], kind="stable")]
    d = rng.normal(0, 1, (nq, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = rng.uniform(5, 80, (nq, 1)).astype(np.float32)
    kind = (np.arange(nq) // 16) % 5
    d[kind == 1] = np.array([1.0, 50.0], np.float32) / np.float32(np.hypot(1, 50))  # steep
    d[kind == 2] = (1.0, 0.01)                    # near horizontal
    d[kind == 3] = (0.0, 1.0)                     # vertical
    length[kind == 4] = 0.0                       # a point: vertical, zero length
    p1 = (c - d * length / 2).astype(np.float32)
    p2 = (c + d * length / 2).astype(np.float32)
    p1[70], p2[70] = t_loc[500] - (10, 0), t_loc[500] + (10, 0)
    p1[71], p2[71] = (100.0, 5000.0), (200.0, 5100.0)  # no target in its band
    unc = (np.arange(nq) // 16) % 7 == 3
    p1[unc] = np.inf
    p2[unc] = np.inf
    q_valid = rng.uniform(size=nq) > 0.2
    q_valid[-50:] = False                         # capacity padding
    q_valid[[70, 71]] = True
    return q, t, t_loc, p1, p2, t_valid, q_valid


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


def _orient_edge_case(w_max, seed=23, k=403):
    """K1's window cases on a 320 x 384 plane: k keypoints (not a multiple of
    the 8 warps of a block) spread over the whole plane, so that many
    windows are clamped at its border, four on its corners, windows from 3
    to 1.2 w_max (the larger cut to w_max), and a NaN, a negative and a
    -0 window (NaN and negative add nothing; -0 samples the centre only)."""
    rng = np.random.default_rng(seed)
    gx, gy = (rng.standard_normal((_H, _W)).astype(np.float32) for _ in range(2))
    loc = np.stack([rng.uniform(-0.4, _W - 0.6, k), rng.uniform(-0.4, _H - 0.6, k)],
                   1).astype(np.float32)
    loc[3:7] = [(0.0, 0.0), (_W - 1.0, _H - 1.0), (-0.4, _H - 0.6), (_W - 0.6, 0.2)]
    sigma = rng.uniform(0.5, 1.2 * w_max / 4.5, k).astype(np.float32)
    sigma[:3] = (np.nan, -1.0, -0.1)
    return gx, gy, loc, sigma


@pytest.mark.cuda
@pytest.mark.parametrize("w_max", [11, 16, 22, 48])
def test_cuda_orientation_windows_match_plain(cuda_device, w_max):
    """K1 at the main path's windows (11, 16, 22) and the widest it takes
    (48), on border keypoints and NaN, negative and -0 windows: within rtol
    1e-4 / atol 1e-5 of the plain version on all but at most 0.5 % of the
    keypoints (K1's gate: atan2f may move a sample lying on a bin edge),
    equal to itself over two calls, and -- since the card's torch.atan2,
    torch.exp and float32 sums round as the kernel's -- bit-identical to the
    restatement of its summation order run on the card."""
    from ssrlcv_tpu_torch.features.orient_kernel import (orientation_histograms,
                                                         orientation_histograms_lanes,
                                                         orientation_histograms_plain)

    gx, gy, loc, sigma = (torch.from_numpy(a).to(cuda_device)
                          for a in _orient_edge_case(w_max))
    args = (gx, gy, loc, sigma, 1.0, w_max, 1.5)
    n = orientation_histograms.launches
    hk = orientation_histograms(*args)
    assert orientation_histograms.launches == n + 1
    assert torch.equal(hk, orientation_histograms(*args))
    assert (hk[:2] == 0).all() and (hk[2] > 0).sum() == 1
    hp = orientation_histograms_plain(*args)
    outside = ~torch.isclose(hk, hp, rtol=1e-4, atol=1e-5).all(dim=1)
    assert int(outside.sum()) <= 0.005 * hk.shape[0]
    assert torch.equal(hk, orientation_histograms_lanes(*args))


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
@pytest.mark.parametrize("with_q_valid", [False, True])
def test_cuda_best_target_tile_skip_matches_plain(cuda_device, with_q_valid):
    """K3 with its y-band tile skip on y-sorted targets and steep, flat,
    vertical and unconstrained segments: idx and dist bit-identical to the
    plain version, with and without q_valid ((0, +inf) on its false rows),
    the same on a second run."""
    from ssrlcv_tpu_torch.matching.match_kernel import best_target, best_target_plain

    q, t, t_loc, p1, p2, t_valid, q_valid = _skip_case()
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, t, t_loc, p1, p2)]
    tv = torch.from_numpy(t_valid).to(cuda_device)
    kw = {"q_valid": torch.from_numpy(q_valid).to(cuda_device)} if with_q_valid else {}
    ik, dk = best_target(*args, 25.0, tv, **kw)
    ik2, dk2 = best_target(*args, 25.0, tv, **kw)
    ip, dp = best_target_plain(*args, 25.0, tv, **kw)
    assert torch.equal(ik, ik2) and torch.equal(dk, dk2)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert int(ik[70]) == 500 and float(dk[71]) == float("inf")
    if with_q_valid:
        off = ~kw["q_valid"]
        assert (ik[off] == 0).all() and torch.isinf(dk[off]).all()


@pytest.mark.cuda
def test_cuda_best_target_layout_matches_restatement(cuda_device):
    """K3's device-side preparation gives the plain restatement's sort
    keys' orders (spatial_order), per-target records (target_meta), boxes
    (tile_boxes) and squared query norms, exactly."""
    from ssrlcv_tpu_torch import _cuda
    from ssrlcv_tpu_torch.matching.match_kernel import (device_orders, layout_buffers,
                                                        spatial_order, target_meta, tile_boxes)

    q, t, t_loc, p1, p2, t_valid, q_valid = (torch.from_numpy(a).to(cuda_device)
                                             for a in _skip_case())
    nq, nt = q.shape[0], t.shape[0]
    lib, stream = _cuda.library(), _cuda.stream_ptr(cuda_device)
    qperm, tperm = device_orders(t_loc, t_valid, p1, p2, q_valid)
    want_q, want_t = spatial_order(t_loc, t_valid, p1, p2, q_valid)
    assert torch.equal(qperm, want_q) and torch.equal(tperm, want_t)
    qn, meta, qbox, tbox = layout_buffers(nq, nt, cuda_device)
    idx = torch.empty(nq, dtype=torch.int32, device=cuda_device)
    dist = torch.empty(nq, dtype=torch.float32, device=cuda_device)
    scratch = torch.empty(nq, dtype=torch.int64, device=cuda_device)
    assert lib.ssrlcv_match_best(
        q.data_ptr(), t.data_ptr(), t_loc.data_ptr(), t_valid.data_ptr(), p1.data_ptr(),
        p2.data_ptr(), q_valid.data_ptr(), qperm.data_ptr(), tperm.data_ptr(), 25.0, nq, nt,
        qn.data_ptr(), meta.data_ptr(), qbox.data_ptr(), tbox.data_ptr(), scratch.data_ptr(),
        idx.data_ptr(), dist.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    want_meta = target_meta(t, t_loc, t_valid, tperm)
    assert torch.equal(meta.view(torch.int32), want_meta.view(torch.int32))
    want_qbox, want_tbox = tile_boxes(t_loc, p1, p2, 25.0, t_valid, q_valid, qperm, tperm)
    assert torch.equal(qbox, want_qbox) and torch.equal(tbox, want_tbox)
    assert torch.equal(qn, (q.int() ** 2).sum(1, dtype=torch.int32))


@pytest.mark.cuda
def test_cuda_descriptor_edge_angles_matches_plain(cuda_device):
    """K2 on keypoints with theta at and near multiples of 45 degrees and
    the widest main-path window (29): uint8 descriptors within 3 of the
    plain version's (the chip gate), raw histograms to float rounding."""
    from ssrlcv_tpu_torch.features.desc_kernel import (descriptor_histograms,
                                                       descriptor_histograms_plain)
    from ssrlcv_tpu_torch.features.descriptor import descriptor_epilogue

    rng = np.random.default_rng(17)
    h = w = 256
    gx, gy = (torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)).to(cuda_device)
              for _ in range(2))
    k = 64
    theta = (np.arange(k) % 8) * np.pi / 4 + rng.choice([0.0, 1e-6, -1e-6], k)
    theta = torch.from_numpy(np.mod(theta, 2 * np.pi).astype(np.float32)).to(cuda_device)
    loc = torch.from_numpy(rng.uniform(40, 216, (k, 2)).astype(np.float32)).to(cuda_device)
    sigma = torch.from_numpy(rng.uniform(1.0, 4.8, k).astype(np.float32)).to(cuda_device)
    vk = descriptor_histograms(gx, gy, loc, theta, sigma, 1.0, 6.0, 29)
    assert torch.equal(vk, descriptor_histograms(gx, gy, loc, theta, sigma, 1.0, 6.0, 29))
    vp = descriptor_histograms_plain(gx, gy, loc, theta, sigma, 1.0, 6.0, 29)
    torch.testing.assert_close(vk, vp, rtol=1e-4, atol=1e-4)
    ones = torch.ones(k, dtype=torch.bool, device=cuda_device)
    diff = descriptor_epilogue(vk, ones).int() - descriptor_epilogue(vp, ones).int()
    assert int(diff.abs().max()) <= 3


@pytest.mark.cuda
def test_cuda_slice_matches_cpu(cuda_device, tmp_path):
    """The 2-view slice on a 256x256 synthetic pair, on the card and on the
    CPU: feature counts within 0.5 %, points after filtering within 1 %, and
    every kernel of the path launched."""
    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams
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


def _mma_tie_case(seed=29, nq=1000, nt=3000):
    """Many equal distances: descriptors of 0s and 1s in 8 bytes (the rest
    0), so a query ties with many targets inside tiles and across them;
    half the rows constrained to short segments, a tail of padding targets,
    Nq not a multiple of 128."""
    rng = np.random.default_rng(seed)
    q = np.zeros((nq, 128), np.uint8)
    t = np.zeros((nt, 128), np.uint8)
    q[:, :8] = rng.integers(0, 2, (nq, 8))
    t[:, :8] = rng.integers(0, 2, (nt, 8))
    t_loc = rng.uniform(0, 1024, (nt, 2)).astype(np.float32)
    t_valid = np.ones(nt, bool)
    t_valid[-700:] = False
    t_valid[rng.integers(0, nt, 100)] = False
    c = rng.uniform(0, 1024, (nq, 2)).astype(np.float32)
    d = rng.normal(0, 1, (nq, 2)).astype(np.float32) * 40
    p1, p2 = (c - d).astype(np.float32), (c + d).astype(np.float32)
    p1[::2] = np.inf
    p2[::2] = np.inf
    return q, t, t_loc, p1, p2, t_valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tile_schedule", "ties"])
def test_cuda_best_target_mma_tiles_match_plain(cuda_device, case):
    """K4 on its tile-schedule cases (ties inside a tile and across tiles,
    an inadmissible target in a live tile, tiles of padding only, all-255
    queries against all-0 and all-255 targets, a valid target at NaN x, no
    admissible target) and on a case of many equal distances: idx and dist
    bit-identical to its plain version and to the restatement of its
    schedule run on the card, equal to itself over two calls, and equal to
    K3 (on the admissible targets, without q_valid) on every row K3
    answers, (0, 3.0e38) on the others."""
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.matching.match_mma import (NO_MATCH_DIST, admissible, best_target_mma,
                                                     best_target_mma_plain,
                                                     best_target_mma_tiled)

    arrays, rows = _mma_tile_case() if case == "tile_schedule" else (_mma_tie_case(), {})
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    n = best_target_mma.launches
    ik, dk = best_target_mma(*args[:5], 25.0, args[5])
    assert best_target_mma.launches == n + 1
    ik2, dk2 = best_target_mma(*args[:5], 25.0, args[5])
    assert torch.equal(ik, ik2) and torch.equal(dk, dk2)
    for ip, dp in (best_target_mma_plain(*args[:5], 25.0, args[5]),
                   best_target_mma_tiled(*args[:5], 25.0, args[5])):
        assert torch.equal(ik, ip) and torch.equal(dk, dp)
    i3, d3 = best_target(*args[:5], 25.0, admissible(args[2], args[5]))
    answered = torch.isfinite(d3)
    assert torch.equal(ik[answered], i3[answered]) and torch.equal(dk[answered], d3[answered])
    assert (ik[~answered] == 0).all() and (dk[~answered] == NO_MATCH_DIST).all()
    if rows:
        assert int(ik[rows["tie_in_tile"]]) == 50 and int(ik[rows["tie_across"]]) == 20
        assert float(dk[rows["far"]]) == 128 * 255 ** 2 and int(ik[rows["same_max"]]) == 801
        assert not bool(answered[rows["invalid_only"]]) and not bool(answered[rows["nothing"]])
    else:
        assert 0 < int(answered.sum()) < len(answered)


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


GATHER_CASES = ["one_plane", "one_band", "edges", "one_key"]


def _gather_case(case, seed=11):
    """K6 inputs that stress its bucketing (csrc/gather.cu): keys on one
    plane only; every key in one band of y slots of one (plane, x0) column,
    with repeated slots; centres beyond the plane's edges, on a plane whose
    H - SPA and W - 256 are not multiples of 8 and 128, so y0 and x0 clip to
    unaligned values; a single key.  Returns (plane, bi, cy, cx) as numpy."""
    rng = np.random.default_rng(seed)
    b, h, w, k = {"one_plane": (4, 256, 512, 300), "one_band": (3, 256, 512, 200),
                  "edges": (3, 301, 388, 400), "one_key": (2, 96, 256, 1)}[case]
    plane = rng.standard_normal((b, h, w)).astype(np.float32)
    bi = rng.integers(0, b, k)
    cy = rng.integers(20, h - 20, k)
    cx = rng.integers(70, w - 70, k)
    if case == "one_plane":
        bi[:] = 2
    elif case == "one_band":  # y0 in 64..120, x0 = 128: slots 8..15 of one column
        bi[:] = 1
        cy = rng.integers(80, 144, k)
        cx = rng.integers(192, 320, k)
    elif case == "edges":
        cy = rng.integers(-40, h + 40, k)
        cx = rng.integers(-80, w + 80, k)
        cy[:4], cx[:4] = (0, 0, h - 1, h - 1), (0, w - 1, 0, w - 1)
    return plane, bi.astype(np.int32), cy.astype(np.int32), cx.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATHER_CASES)
def test_cuda_patch_row_sums_buckets_match_plain(cuda_device, case):
    """K6 on the bucketing cases: one launch, bit-identical to its plain
    version and to itself."""
    from ssrlcv_tpu_torch.bench.gather_patches import patch_row_sums, patch_row_sums_plain

    args = [torch.from_numpy(a).to(cuda_device) for a in _gather_case(case)]
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
    with pytest.raises(ValueError, match="W % 4"):
        patch_row_sums(torch.zeros((2, 256, 514), device=cuda_device), k, k, k, 33)


def _dense_grid(cuda_device, size=256, seed=7):
    """The dense path's inputs on a size^2 image: the gradient planes of
    the min-max-normalised image, every interior pixel (border 12) as a
    keypoint at unit sigma, and an angle per keypoint."""
    from ssrlcv_tpu_torch.features.dense import _interior_grid
    from ssrlcv_tpu_torch.ops import image_ops as ops

    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.integers(0, 256, (size, size)).astype(np.uint8)).to(cuda_device)
    gx, gy = ops.pixel_gradients(ops.normalize_minmax(ops.to_float(img)))
    loc = _interior_grid(size, size, 12, device=cuda_device)
    k = loc.shape[0]
    sigma = torch.ones(k, device=cuda_device)
    theta = torch.from_numpy(rng.uniform(0, 2 * np.pi, k).astype(np.float32)).to(cuda_device)
    return gx, gy, loc, sigma, theta


@pytest.mark.cuda
def test_cuda_dense_grid_descriptor_matches_plain(cuda_device):
    """K2 over every interior pixel of a 256^2 image (53,824 keypoints on a
    stride-1 grid, window 6): uint8 descriptors within 3 of the plain
    version's, raw histograms within rtol/atol 1e-4 on >= 99.5 % of the
    keypoints (atan2f may move a sample lying on a bin edge), equal to
    itself over two calls, one launch a call."""
    from ssrlcv_tpu_torch.features.desc_kernel import (descriptor_histograms,
                                                       descriptor_histograms_plain)
    from ssrlcv_tpu_torch.features.descriptor import descriptor_epilogue

    gx, gy, loc, sigma, theta = _dense_grid(cuda_device)
    args = (gx, gy, loc, theta, sigma, 1.0, 6.0, 6)
    n = descriptor_histograms.launches
    vk = descriptor_histograms(*args)
    assert descriptor_histograms.launches == n + 1 and vk.shape == (232 * 232, 128)
    assert torch.equal(vk, descriptor_histograms(*args))
    vp = descriptor_histograms_plain(*args)
    ones = torch.ones(loc.shape[0], dtype=torch.bool, device=cuda_device)
    d = (descriptor_epilogue(vk, ones).int() - descriptor_epilogue(vp, ones).int()).abs()
    assert int(d.max()) <= 3
    outside = ~torch.isclose(vk, vp, rtol=1e-4, atol=1e-4).all(dim=1)
    assert int(outside.sum()) <= 0.005 * loc.shape[0]


@pytest.mark.cuda
def test_cuda_dense_grid_orientation_matches_plain(cuda_device):
    """K1 at window 5 over the same 53,824 grid keypoints: within rtol
    1e-4 / atol 1e-5 of the plain version on all but <= 0.5 % of them,
    bit-identical to the restatement of its summation order on the card,
    equal to itself over two calls."""
    from ssrlcv_tpu_torch.features.orient_kernel import (orientation_histograms,
                                                         orientation_histograms_lanes,
                                                         orientation_histograms_plain)

    gx, gy, loc, sigma, _ = _dense_grid(cuda_device)
    args = (gx, gy, loc, sigma, 1.0, 5, 1.5)
    n = orientation_histograms.launches
    hk = orientation_histograms(*args)
    assert orientation_histograms.launches == n + 1
    assert torch.equal(hk, orientation_histograms(*args))
    hp = orientation_histograms_plain(*args)
    outside = ~torch.isclose(hk, hp, rtol=1e-4, atol=1e-5).all(dim=1)
    assert int(outside.sum()) <= 0.005 * loc.shape[0]
    assert torch.equal(hk, orientation_histograms_lanes(*args))


def _dense_slots(fs):
    """{(y, x, rank): (theta, descriptor)}: rows keyed by slot, the rank of
    a row being its place among the rows of its pixel."""
    m = fs.mask.cpu().numpy()
    loc, theta, desc = (t.cpu().numpy()[m] for t in (fs.loc, fs.theta, fs.descriptors))
    out, seen = {}, {}
    for (x, y), t, d in zip(loc.tolist(), theta, desc):
        r = seen.get((y, x), 0)
        seen[(y, x)] = r + 1
        out[(y, x, r)] = (float(t), d.astype(np.int32))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
def test_cuda_dense_sift_matches_cpu(cuda_device, fast):
    """generate_dense_sift on the card against device="cpu" on one 96x96
    image: slot sets agree on >= 99.5 %, common descriptors within 3; the
    fast path launches K2 once and K1 never, the gather path each once."""
    from ssrlcv_tpu_torch.features.dense import generate_dense_sift
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms

    rng = np.random.default_rng(5)
    img = np.kron(rng.integers(0, 255, (12, 12)).astype(np.uint8), np.ones((8, 8), np.uint8))
    before = (orientation_histograms.launches, descriptor_histograms.launches)
    g = generate_dense_sift(img, fast=fast, device=cuda_device)
    launched = (orientation_histograms.launches - before[0],
                descriptor_histograms.launches - before[1])
    assert launched == ((0, 1) if fast else (1, 1))
    a, b = _dense_slots(g), _dense_slots(generate_dense_sift(img, fast=fast, device="cpu"))
    common = set(a) & set(b)
    assert len(common) >= 0.995 * max(len(a), len(b)) and len(common) > 3000
    assert max(int(np.abs(a[k][1] - b[k][1]).max()) for k in common) <= 3


def _pushbroom_case(seed=31, n=2000):
    """A 2-view match set over a 2048x1024 scan at rolls 88 and 92 deg (the
    HiRISE-like camera of tests/test_pushbroom.py), as port tensors."""
    from ssrlcv_tpu_torch.core.types import MatchSet, PushbroomCameras

    rng = np.random.default_rng(seed)
    loc = rng.uniform(0, [2048, 1024], (n, 2, 2)).astype(np.float32)
    fov = 1.14 * np.pi / 180.0
    dpix = 0.012 * np.tan(fov / 2.0) / 1024.0
    mask = np.ones(n, bool)
    mask[-7:] = False
    ms = MatchSet.from_numpy(kp_loc=loc, kp_parent=np.tile([0, 1], (n, 1)).astype(np.int32),
                             num_views=np.full(n, 2, np.int32), mask=mask)
    f32 = lambda v: np.full(2, v, np.float32)  # noqa: E731
    pb = PushbroomCameras.from_numpy(
        start_pos=np.zeros((2, 3), np.float32), end_pos=np.zeros((2, 3), np.float32),
        projection_center=np.zeros((2, 2), np.float32), axis_radius=f32(3396.19),
        roll=np.array([88.0, 92.0], np.float32), altitude=f32(300.0), foc=f32(0.012),
        fov=f32(fov), gsd=f32(0.25e-3), dpix=np.tile([dpix, 0.0], (2, 1)).astype(np.float32),
        size=np.tile([2048, 1024], (2, 1)).astype(np.int32))
    return ms, pb


def _to(obj, dev):
    return type(obj)(**{k: torch.as_tensor(v, device=dev) for k, v in obj.to_numpy().items()})


@pytest.mark.cuda
def test_cuda_pushbroom_bundles_match_cpu(cuda_device):
    """Pushbroom rays, their 2-view triangulation and the two filters on
    the card equal the CPU port's bit for bit (the transcendentals are
    float64 rounded once, every other step a separately rounded float32
    operation), twice."""
    from ssrlcv_tpu_torch.geometry import filters as F
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches

    ms, pb = _pushbroom_case()
    ref = generate_bundles(ms, None, pushbrooms=pb)
    ref_pc, _ = triangulate_matches(ms, None, pushbrooms=pb)
    ref_lin = F.linear_cutoff_filter(ms, None, 100.0, pushbrooms=pb)
    ref_stat = F.deterministic_statistical_filter(ref_lin, None, 3.0, 10, pushbrooms=pb)
    gms, gpb = _to(ms, cuda_device), _to(pb, cuda_device)
    for _ in range(2):
        bd = generate_bundles(gms, None, pushbrooms=gpb)
        assert torch.equal(bd.vec.cpu(), ref.vec) and torch.equal(bd.pnt.cpu(), ref.pnt)
        pc, _ = triangulate_matches(gms, None, pushbrooms=gpb)
        assert torch.equal(pc.mask.cpu(), ref_pc.mask)
        assert torch.equal(pc.points.cpu(), ref_pc.points)
        lin = F.linear_cutoff_filter(gms, None, 100.0, pushbrooms=gpb)
        stat = F.deterministic_statistical_filter(lin, None, 3.0, 10, pushbrooms=gpb)
        assert torch.equal(lin.mask.cpu(), ref_lin.mask)
        assert torch.equal(stat.mask.cpu(), ref_stat.mask)


@pytest.mark.cuda
def test_cuda_octree_normals_match_cpu(cuda_device):
    """The Morton octree, windowed and exact kNN and the low-density filter
    on the card equal the CPU port's exactly; normals within 1e-6 (each
    device's float64 eigensolver, rounded once); twice."""
    from ssrlcv_tpu_torch.mesh import octree as oc

    rng = np.random.default_rng(37)
    xy = rng.uniform(-50, 50, (3000, 2))
    pts = np.column_stack([xy, 5 * np.sin(xy[:, 0] / 10) + rng.normal(0, 0.2, 3000)])
    pts = pts.astype(np.float32)
    mask = rng.uniform(size=3000) > 0.05
    cams = np.array([[0.0, 0.0, 400.0], [30.0, 0.0, 400.0]], np.float32)
    ct = oc.build_octree(pts, mask, device="cpu")
    want = (oc.knn(ct, k=8), oc.knn_exact(ct.points, ct.mask, k=6),
            oc.compute_normals(ct, cams), oc.remove_low_density_points(ct).mask)
    for _ in range(2):
        gt = oc.build_octree(pts, mask, device=cuda_device)
        for a, b in zip(gt[:4], ct[:4]):
            assert torch.equal(a.cpu(), b)
        (gi, gd), (ei, ed) = oc.knn(gt, k=8), oc.knn_exact(gt.points, gt.mask, k=6)
        assert torch.equal(gi.cpu(), want[0][0]) and torch.equal(gd.cpu(), want[0][1])
        assert torch.equal(ei.cpu(), want[1][0]) and torch.equal(ed.cpu(), want[1][1])
        n = oc.compute_normals(gt, cams).cpu()
        assert float((n - want[2]).abs().max()) <= 1e-6
        assert torch.equal(oc.remove_low_density_points(gt).mask.cpu(), want[3])


@pytest.mark.cuda
def test_cuda_marching_tetrahedra_match_cpu(cuda_device):
    """marching_tetrahedra on a sphere field on the card equals the CPU
    port's triangles bit for bit, and compact_mesh the same mesh; twice."""
    from ssrlcv_tpu_torch.mesh.marching_cubes import compact_mesh, marching_tetrahedra

    ax = np.linspace(-1.2, 1.2, 40).astype(np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    field = torch.from_numpy((1.0 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)).astype(np.float32))
    origin = torch.full((3,), -1.2)
    spacing = torch.full((3,), float(ax[1] - ax[0]))
    tris, mask = marching_tetrahedra(field, origin, spacing)
    verts, faces = compact_mesh(tris, mask)
    for _ in range(2):
        gt, gm = marching_tetrahedra(field.to(cuda_device), origin.to(cuda_device),
                                     spacing.to(cuda_device))
        assert torch.equal(gm.cpu(), mask) and torch.equal(gt.cpu(), tris)
        gv, gf = compact_mesh(gt, gm)
        np.testing.assert_array_equal(gv, verts)
        np.testing.assert_array_equal(gf, faces)
