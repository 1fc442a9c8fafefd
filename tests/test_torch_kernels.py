"""The port's kernel modules against the JAX package, on the CPU.

Each kernel wrapper of ssrlcv_tpu_torch takes its plain PyTorch version for
CPU tensors; these tests hold that plain version against the JAX function it
replaces on identical numpy-seeded inputs (the Pallas kernels run in
interpret mode, as the JAX package's own tests run them).
test_torch_cuda.py holds the CUDA kernels against the same plain versions on
a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import (GATHER_CASES, _H, _K, _W, _WMAX, _gather_case, _match_case,
                             _orient_inputs, _plane)

torch.set_num_threads(2)


@pytest.mark.parametrize("jax_form", ["gather", "pallas_interpret"])
def test_orientation_plain_matches_jax(jax_form):
    """K1's plain version vs _histogram_for_keypoints: its gather form and
    the Pallas kernel in interpret mode.  Tolerance rtol 2e-5 / atol 1e-6:
    float32 sums over up to 625 samples in another order."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.orientation import _histogram_for_keypoints
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms

    lam = SIFTParams().orientation_contrib_width
    grads, loc, sigma = _orient_inputs()
    blur = jnp.ones((_K,), jnp.int32)
    mask = jnp.ones((_K,), bool)
    if jax_form == "gather":
        ref, _ = _histogram_for_keypoints(jnp.asarray(grads), blur, jnp.asarray(loc),
                                          jnp.asarray(sigma), mask, 1.0, lam, _WMAX)
    else:
        ref, _ = _histogram_for_keypoints(jnp.asarray(grads[1]), blur, jnp.asarray(loc),
                                          jnp.asarray(sigma), mask, 1.0, lam, _WMAX,
                                          use_kernel=True)
    gx, gy = _plane(grads)
    got = orientation_histograms(gx, gy, torch.from_numpy(loc), torch.from_numpy(sigma),
                                 1.0, _WMAX, lam)
    assert got.shape == (_K, 36)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("jax_form", ["gather", "pallas_interpret"])
def test_orientation_lane_order_matches_jax_and_plain(jax_form):
    """The restatement of K1's summation order (orientation_histograms_lanes:
    per-lane sums in sample order, then the lanes in a fixed order) against
    _histogram_for_keypoints (its gather form and the Pallas kernel in
    interpret mode) within the tolerance of
    test_orientation_plain_matches_jax, rtol 2e-5 / atol 1e-6, and against
    the plain version within the same; keypoints with a NaN and a negative
    window give all zeros."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.orientation import _histogram_for_keypoints
    from ssrlcv_tpu_torch.features.orient_kernel import (orientation_histograms_lanes,
                                                         orientation_histograms_plain)

    lam = SIFTParams().orientation_contrib_width
    grads, loc, sigma = _orient_inputs()
    sigma[0], sigma[1] = np.nan, -1.0
    blur = jnp.ones((_K,), jnp.int32)
    mask = jnp.ones((_K,), bool)
    g = jnp.asarray(grads if jax_form == "gather" else grads[1])
    ref, _ = _histogram_for_keypoints(g, blur, jnp.asarray(loc), jnp.asarray(sigma), mask, 1.0,
                                      lam, _WMAX, use_kernel=jax_form == "pallas_interpret")
    gx, gy = _plane(grads)
    args = (gx, gy, torch.from_numpy(loc), torch.from_numpy(sigma), 1.0, _WMAX, lam)
    got = orientation_histograms_lanes(*args)
    assert got.shape == (_K, 36) and (got[:2] == 0).all() and (got[2:].sum(1) > 0).all()
    ref = np.nan_to_num(np.asarray(ref))  # the JAX forms give NaN for a NaN window
    np.testing.assert_allclose(got.numpy()[1:], ref[1:], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), orientation_histograms_plain(*args).numpy(),
                               rtol=2e-5, atol=1e-6)


def test_descriptor_plain_matches_jax_gather():
    """K2's plain version + epilogue vs fill_descriptors' gather form, on
    uint8 descriptors: within 1, because the histogram sums run in another
    order (torch's batched product vs XLA's dot) and a value sitting on a
    .5 quantisation boundary may round either way."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu.features.descriptor import fill_descriptors
    from ssrlcv_tpu.features.detector import SSKeyPoints
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.descriptor import descriptor_epilogue

    rng = np.random.default_rng(7)
    params = SIFTParams()
    grads = rng.standard_normal((3, _H, _W, 2)).astype(np.float32)
    loc = rng.uniform(_WMAX + 4, 300, (_K, 2)).astype(np.float32)
    sigma = rng.uniform(1.0, 2.0, (_K,)).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, (_K,)).astype(np.float32)
    kps = SSKeyPoints(blur=jnp.ones((_K,), jnp.int32), loc=jnp.asarray(loc),
                      intensity=jnp.zeros((_K,), jnp.float32), sigma=jnp.asarray(sigma),
                      theta=jnp.asarray(theta), mask=jnp.ones((_K,), bool))
    ref, _ = fill_descriptors(jnp.asarray(grads), kps, 1.0, params, w_max=_WMAX)

    gx, gy = _plane(grads)
    raw = descriptor_histograms(gx, gy, torch.from_numpy(loc), torch.from_numpy(theta),
                                torch.from_numpy(sigma), 1.0,
                                params.descriptor_contrib_width, _WMAX)
    got = descriptor_epilogue(raw, torch.ones(_K, dtype=torch.bool))
    diff = np.abs(got.numpy().astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99


def _k2_bins(ang):
    """K2's bin selection restated: the bins among floor(ang * 4/pi) - 1 ..
    + 2 (inside 0..7) that pass |ang - b*pi/4| < pi/4, as an (S, 8) mask."""
    from ssrlcv_tpu_torch.features.desc_kernel import INV_RAD45, RAD45

    b0 = torch.floor(ang * INV_RAD45).to(torch.int64)
    got = torch.zeros((ang.shape[0], 8), dtype=torch.bool)
    for i in (-1, 0, 1, 2):
        b = b0 + i
        inside = (b >= 0) & (b <= 7)
        bc = torch.clamp(b, 0, 7)
        ok = inside & (torch.abs(ang - bc.to(torch.float32) * RAD45) < RAD45)
        got[torch.arange(ang.shape[0])[ok], bc[ok]] = True
    return got


def test_descriptor_candidates_cover_the_plain_triples():
    """K2 adds a sample only to the (cell, bin) pairs that its candidate
    selection yields: the cells passing the exact cell test against the 16
    rotated centres, the bins passing the exact bin test among the 4 around
    floor(angle * 4/pi).  On keypoints with theta at and next to multiples
    of 45 degrees and angles at and next to bin edges (negative, and next to
    2 pi, as the unwrapped reference angle can be), that set equals the
    (sample, cell, bin) triples descriptor_histograms_plain weights non-zero
    or tests true, and has at most 2 bins and 5 cells of non-zero weight
    (the image-frame cell box meets 5 rotated centres near 45 degrees)."""
    from ssrlcv_tpu_torch.features.desc_kernel import _CELL_X, _CELL_Y, RAD45

    rng = np.random.default_rng(3)
    # bin selection on every angle class the reference angle can take
    edges = np.arange(-1, 9) * np.pi / 4
    ang = np.concatenate([edges, np.nextafter(edges, 10), np.nextafter(edges, -10),
                          rng.uniform(-np.pi / 4, 2 * np.pi, 4000)]).astype(np.float32)
    ang = torch.from_numpy(ang[(ang > -2 * np.pi) & (ang < 2 * np.pi)])
    kk = torch.arange(8, dtype=torch.float32) * RAD45
    plain = torch.abs(ang[:, None] - kk[None, :]) < RAD45  # the plain version's bin test
    got = _k2_bins(ang)
    assert torch.equal(got, plain) and int(got.sum(1).max()) <= 2

    # cells: every in-window lattice sample of keypoints with edge angles
    k = 48
    theta = torch.from_numpy(np.mod((np.arange(k) % 8) * np.pi / 4
                                    + rng.choice([0.0, 1e-6, -1e-6, 1e-3], k),
                                    2 * np.pi).astype(np.float32))
    win = torch.from_numpy(rng.integers(2, 30, k).astype(np.float32))
    for kp in range(k):
        w, ct, st = win[kp], torch.cos(theta[kp]), torch.sin(theta[kp])
        offs = torch.arange(-int(w), int(w) + 1, dtype=torch.float32)
        dy, dx = (g.reshape(-1) for g in torch.meshgrid(offs, offs, indexing="ij"))
        cx, cy = dx * ct - dy * st, dx * st + dy * ct
        inw = (cx.abs() <= w) & (cy.abs() <= w)
        cx, cy = cx[inw], cy[inw]
        hx0 = torch.tensor(_CELL_X) * w
        hy0 = torch.tensor(_CELL_Y) * w
        hx, hy = hx0 * ct - hy0 * st, hx0 * st + hy0 * ct
        binw = w / 2.0
        ddx = torch.abs(hx[None, :] - cx[:, None])
        ddy = torch.abs(hy[None, :] - cy[:, None])
        in_cell = (ddx <= binw) & (ddy <= binw)
        weight = torch.where(in_cell, (1.0 - ddx / binw) * (1.0 - ddy / binw), 0.0)
        assert int((weight > 0).sum(1).max()) <= 5
        assert int(in_cell.sum(1).max()) <= 9


def test_best_target_plain_matches_jax_chunked():
    """K3's plain version vs best_target_chunked + _epipolar_segment_mask
    (constrained rows) and best_target_chunked alone (unconstrained rows):
    indices and distances identical."""
    from ssrlcv_tpu.matching.distance import best_target_chunked
    from ssrlcv_tpu.matching.match import _epipolar_segment_mask
    from ssrlcv_tpu_torch.matching.match_kernel import best_target

    eps = 25.0
    q, t, t_loc, p1, p2, t_valid, unc = _match_case()
    jt, jtl, jtv = jnp.asarray(t), jnp.asarray(t_loc), jnp.asarray(t_valid)
    c = ~unc
    ji, jd = best_target_chunked(
        jnp.asarray(q[c]), jt, jtv,
        mask_fn=lambda a, b: _epipolar_segment_mask(a, b, jtl, eps),
        mask_aux=(jnp.asarray(p1[c]), jnp.asarray(p2[c])), chunk=128)
    ui, ud = best_target_chunked(jnp.asarray(q[unc]), jt, jtv, chunk=128)

    idx, dist = best_target(*(torch.from_numpy(a) for a in (q, t, t_loc, p1, p2)), eps,
                            torch.from_numpy(t_valid))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy()[c], np.asarray(ji))
    np.testing.assert_array_equal(dist.numpy()[c], np.asarray(jd))
    np.testing.assert_array_equal(idx.numpy()[unc], np.asarray(ui))
    np.testing.assert_array_equal(dist.numpy()[unc], np.asarray(ud))
    assert idx[260] == 9 and dist[260] == 0.0      # tie -> lowest index
    assert idx[6] == 0 and dist[6] == np.inf       # nothing passes
    assert t_valid[idx.numpy()[np.isfinite(dist.numpy())]].all()  # invalid never wins


def test_distance_matrix_exact():
    """Exact integer distances over the full uint8 range, and min_distance
    as the minimum over valid targets."""
    from ssrlcv_tpu_torch.matching.distance import distance_matrix, min_distance

    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (64, 128)).astype(np.uint8)
    t = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    d = distance_matrix(torch.from_numpy(q), torch.from_numpy(t))
    expect = ((q.astype(np.int64)[:, None] - t.astype(np.int64)[None]) ** 2).sum(-1)
    assert d.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), expect)
    valid = rng.uniform(size=96) > 0.3
    got = min_distance(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(valid), chunk=16)
    np.testing.assert_array_equal(got.numpy(), expect[:, valid].min(1).astype(np.float32))


def _strat_h_numpy(packed, bi, cy, cx, s):
    """scripts/bench_gather2.py's strat_h restated in numpy: the aligned
    (SPA, 256) patch per keypoint, |p| summed over its rows (in row order,
    float32), the first 128 lanes."""
    _, h, w = packed.shape
    spa = ((s + 7) // 8) * 8 + 8
    y0 = np.clip((cy - s // 2) & ~7, 0, h - spa)
    x0 = np.clip((cx - 64) & ~127, 0, w - 256)
    out = np.zeros((len(bi), 128), np.float32)
    for k in range(len(bi)):
        patch = packed[bi[k], y0[k]:y0[k] + spa, x0[k]:x0[k] + 256]
        acc = np.zeros(256, np.float32)
        for row in patch:
            acc += np.abs(row)
        out[k] = acc[:128]
    return out


@pytest.mark.parametrize("case", GATHER_CASES)
def test_patch_row_sums_slots_and_bytes(case):
    """On K6's bucketing cases: the plain version bit-identical to strat_h's
    numpy restatement; every key in the slot its origins name, one slot per
    distinct (plane, x0, y0) (the mapping of csrc/gather.cu, whose schedule
    the card tests hold to the plain version); ``function_bytes`` counting
    each plane element under some key's patch once."""
    from ssrlcv_tpu_torch.bench.gather_patches import (_origins, function_bytes, key_slots,
                                                       patch_row_sums_plain, slot_geometry)

    plane, bi, cy, cx = _gather_case(case)
    args = [torch.from_numpy(a) for a in (plane, bi, cy, cx)]
    np.testing.assert_array_equal(patch_row_sums_plain(*args).numpy(),
                                  _strat_h_numpy(plane, bi, cy, cx, 33))
    b, h, w = plane.shape
    nx, ny, nslots = slot_geometry(b, h, w, 33)
    slot = key_slots(*args[1:], 33, h, w).numpy()
    assert 0 <= slot.min() and slot.max() < nslots
    y0, x0 = (t.numpy() for t in _origins(args[2], args[3], 33, h, w))
    # one slot per distinct (plane, x0, y0), and back: y0 = min(8 * ys, H - SPA)
    np.testing.assert_array_equal(slot // ny % nx, -(-x0 // 128))
    np.testing.assert_array_equal(np.minimum(slot % ny * 8, h - 48), y0)
    np.testing.assert_array_equal(np.minimum(slot // ny % nx * 128, w - 256), x0)
    assert len(np.unique(slot)) == len({(a, c, d) for a, c, d in zip(bi, x0, y0)})
    covered = np.zeros(plane.shape, bool)
    for k in range(len(bi)):
        covered[bi[k], y0[k]:y0[k] + 48, x0[k]:x0[k] + 128] = True
    k = len(bi)
    assert function_bytes(*args) == covered.sum() * 4 + 3 * k * 4 + k * 128 * 4


def test_patch_row_sums_plain_matches_strat_h():
    """K6's plain version against a numpy restatement of strat_h (the
    script itself cannot be imported: at import it sets a compilation cache
    inside the repo and allocates its full-size data), bit-identical, at
    B,H,W = 4,256,512 and K = 64 (the script's generator draws planes from
    1..B-2, so B = 4 exercises two).  The packing equals the script's jnp
    pack."""
    from ssrlcv_tpu_torch.bench.gather_patches import make_inputs, pack, patch_row_sums

    inp = make_inputs(seed=0, b=4, h=256, w=512, k=64)
    np_in = {k: v.numpy() for k, v in inp.items()}
    assert set(np.unique(np_in["bi"])) == {1, 2}
    got = patch_row_sums(inp["packed"], inp["bi"], inp["cy"], inp["cx"], 33)
    ref = _strat_h_numpy(np_in["packed"], np_in["bi"], np_in["cy"], np_in["cx"], 33)
    np.testing.assert_array_equal(got.numpy(), ref)

    g = jnp.asarray(np_in["grads"][:1, :8])
    u = g.astype(jnp.float16).view(jnp.uint16).astype(jnp.uint32)
    jpacked = (u[..., 0] | (u[..., 1] << 16)).view(jnp.float32)
    np.testing.assert_array_equal(pack(np_in["grads"][:1, :8]).view(np.uint32),
                                  np.asarray(jpacked).view(np.uint32))


def _wrapper_calls():
    from ssrlcv_tpu_torch.bench.gather_patches import patch_row_sums
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.patches import extract_patches
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.matching.match_mma import best_target_mma

    def orient(dev="cpu", dtype=torch.float32, k=4, contiguous=True):
        g = torch.zeros((32, 32), dtype=dtype, device=dev)
        loc = torch.full((k, 2), 16.0, device=dev)
        if not contiguous:
            loc = torch.full((2, k), 16.0, device=dev).T
        return orientation_histograms(g, g, loc, torch.ones(4, device=dev), 1.0, 4, 1.5)

    def desc(dev="cpu", dtype=torch.float32, k=4, contiguous=True):
        g = torch.zeros((32, 32), dtype=dtype, device=dev)
        loc = torch.full((k, 2), 16.0, device=dev)
        if not contiguous:
            loc = torch.full((2, k), 16.0, device=dev).T
        z = torch.ones(4, device=dev)
        return descriptor_histograms(g, g, loc, z, z, 1.0, 6.0, 6)

    def match(dev="cpu", dtype=torch.uint8, k=4, contiguous=True, fn=best_target):
        q = torch.zeros((4, 128), dtype=dtype, device=dev)
        t = torch.zeros((4, 128), dtype=torch.uint8, device=dev)
        loc = torch.zeros((k, 2), device=dev)
        if not contiguous:
            loc = torch.zeros((2, k), device=dev).T
        p = torch.full((4, 2), torch.inf, device=dev)
        return fn(q, t, loc, p, p, 0.0, torch.ones(4, dtype=torch.bool, device=dev))

    def patches(dev="cpu", dtype=torch.float32, k=4, contiguous=True):
        gx = torch.zeros((64, 256), dtype=dtype, device=dev)
        gy = torch.zeros((64, 252 + k), dtype=dtype, device=dev)  # k != 4: unequal planes
        loc = torch.full((4, 2), 16.0, device=dev)
        if not contiguous:
            loc = torch.full((2, 4), 16.0, device=dev).T
        return extract_patches(gx, gy, loc, 12)

    def row_sums(dev="cpu", dtype=torch.int32, k=4, contiguous=True):
        plane = torch.zeros((3, 64, 256), device=dev)
        bi = torch.ones(k, dtype=dtype, device=dev)
        c = torch.full((4,), 32, dtype=torch.int32, device=dev)
        if not contiguous:
            c = torch.full((4, 2), 32, dtype=torch.int32, device=dev)[:, 0]
        return patch_row_sums(plane, bi, c, c, 33)

    return {"orient": orient, "desc": desc, "match": match,
            "match_mma": lambda **kw: match(fn=best_target_mma, **kw),
            "patches": patches, "row_sums": row_sums}


@pytest.mark.parametrize("name", ["orient", "desc", "match", "match_mma", "patches",
                                  "row_sums"])
def test_wrapper_argument_checks(name):
    """Each wrapper rejects a wrong dtype, a wrong shape, a non-contiguous
    operand and a device it has no path for (a meta tensor stands in for a
    non-CPU tensor here: the CUDA branch launches or raises, it never falls
    back to the plain version)."""
    call = _wrapper_calls()[name]
    call()  # the CPU path runs
    with pytest.raises(TypeError):
        call(dtype={"match": torch.int32, "match_mma": torch.int32,
                    "row_sums": torch.int64}.get(name, torch.float64))
    with pytest.raises(ValueError):
        call(k=5)
    with pytest.raises(ValueError, match="contiguous"):
        call(contiguous=False)
    with pytest.raises(ValueError, match="unsupported device"):
        call(dev="meta")


def test_cpu_path_counts_no_launch_and_builds_nothing(monkeypatch):
    """CPU tensors take the plain versions: no launch is counted and the
    kernel library is never built or loaded."""
    from ssrlcv_tpu_torch import _cuda
    from ssrlcv_tpu_torch.bench.gather_patches import patch_row_sums
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.patches import extract_patches
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.matching.match_mma import best_target_mma

    def no_build():
        raise AssertionError("the kernel library was requested on the CPU path")

    monkeypatch.setattr(_cuda, "library", no_build)
    wrappers = (orientation_histograms, descriptor_histograms, best_target, best_target_mma,
                extract_patches, patch_row_sums)
    before = [f.launches for f in wrappers]
    for call in _wrapper_calls().values():
        call()
    assert [f.launches for f in wrappers] == before


def test_library_name_tracks_the_sources(tmp_path, monkeypatch):
    """The built library's name hashes the kernel sources, so an edited
    source never loads a stale library."""
    from ssrlcv_tpu_torch import _cuda

    first = _cuda.library_path()
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _cuda._sources():
        (src / p.rsplit("/", 1)[-1]).write_bytes(open(p, "rb").read())
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(src))
    assert _cuda.library_path() == first
    (src / "match.cu").write_text((src / "match.cu").read_text() + "\n// edited\n")
    assert _cuda.library_path() != first
