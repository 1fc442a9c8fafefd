"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each fails the run by raising; nothing falls back to the CPU):
  0. the card (nvidia-smi name and power limit) and the torch / CUDA / nvcc
     versions;
  1. the build of the hand-written kernels (csrc/*.cu, nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (a seeded synthetic 1024x1024 scene): K1 orientation and
     K2 descriptor histograms on the 2048^2 octave-0 planes with each blur
     bucket's keypoints; K5 patch extraction on the same keypoints, then the
     use_patches route of orientation and descriptors (K5 + the plain
     histogram math) against the K1 / K2 route; K3 best-target at 65536 x
     65536 capacity, both the unconstrained seed pass and the constrained
     match, and K4 (the tensor-core best target) on the same passes against
     K3 and its plain version; K6 at the patch-gather benchmark's shapes
     (ssrlcv_tpu_torch.bench.gather_patches); tolerances below;
  3. the 2-view main path through ssrlcv_tpu_torch.pipeline.stages on
     cuda:0 (seed SIFT + run_pipeline), with per-stage CUDA-event times, the
     reconstruction's own checks (points, BA error, distance to the scene's
     true surface) and the kernels' launch counters; then the same path once
     more, warm, for its stage times without one-time set-up;
  3b. the same pair in the brute-force matching configuration
     (MatchParams(mode="brute")), then K4 on that run's two feature sets
     against K3;
  4. the everest fixture pair, only where the JAX benchmark's fixture
     directory exists.

Kernel times are device times from CUDA events over back-to-back launches
queued behind a device-side sleep (ssrlcv_tpu_torch.bench.timing).  Each
path that runs a kernel sets its launch counters to 0 just before and reads
them just after; launches made only to compare a kernel with its plain
version are not counted.

Exits non-zero on any failure, and at once, printing no result, when no CUDA
device is available or the script is not run from the root of a checkout.
The second-to-last line is a JSON object of the kernels' measurements; the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SIZE = 1024
# tolerances of each kernel against its plain version on the same inputs
K1_RTOL, K1_ATOL, K1_MAX_FLIP_FRACTION = 1e-4, 1e-5, 0.005
K2_MAX_U8_DIFF = 3
K4_NO_MATCH = (0, 3.0e38)  # K4's (idx, dist) for a query with no admissible target
MIN_POINTS = 1000          # the reconstruction-collapse bound of bench.py
MAX_SURFACE_MEDIAN_M = 100.0


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int, what: str) -> float:
    """Device milliseconds of ``fn()`` (bench.timing.cuda_ms), marked in the
    output when the host could not keep the launches queued."""
    from ssrlcv_tpu_torch.bench.timing import cuda_ms as device_ms

    ms, queued = device_ms(fn, reps, tries=3 if reps > 1 else 1)
    if not queued:
        print(f"[timing] {what}: host-bound, the window includes host gaps")
    return ms


def phase_env():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    from ssrlcv_tpu_torch import _cuda

    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    from ssrlcv_tpu_torch import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    built = _cuda.build_seconds
    print(f"[build] {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s"
          + (f" (nvcc {built:.2f} s)" if built is not None else " (already built)"))


def _same_twice(fn):
    a = fn()
    b = fn()
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(a, b)), a


def _k1_gate(hk, hp):
    """(max |kernel - plain|, keypoints outside rtol/atol) of K1's gate."""
    close = torch.isclose(hk, hp, rtol=K1_RTOL, atol=K1_ATOL).all(dim=1)
    return float((hk - hp).abs().max()) if hk.numel() else 0.0, int((~close).sum())


def _u8_diff(a, b) -> int:
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def phase_kernels_features(scene, dev):
    """K1, K2 and K5 (with the use_patches route) against their plain
    versions on octave 0 of image 0.  Returns the per-kernel records."""
    from ssrlcv_tpu.config import SIFTParams
    from ssrlcv_tpu_torch.features import scale_space as ss
    from ssrlcv_tpu_torch.features.desc_kernel import (descriptor_histograms,
                                                       descriptor_histograms_plain)
    from ssrlcv_tpu_torch.features.descriptor import descriptor_epilogue, fill_descriptors
    from ssrlcv_tpu_torch.features.detector import check_descriptor_border, find_keypoints_octave
    from ssrlcv_tpu_torch.features.orient_kernel import (orientation_histograms,
                                                         orientation_histograms_plain)
    from ssrlcv_tpu_torch.features.orientation import (_histogram_for_keypoints,
                                                       compute_orientations)
    from ssrlcv_tpu_torch.features.patches import extract_patches, extract_patches_plain
    from ssrlcv_tpu_torch.features.sift import _bucket_windows, _describe_buckets, octave_capacity
    from ssrlcv_tpu_torch.ops import image_ops as ops

    params = SIFTParams()
    px = torch.as_tensor(scene.images[0].pixels, device=dev)
    octave = ss.build_scale_space(px, params, SIZE, SIZE)[0]
    sigmas = tuple(ss.octave_sigmas(params, 0))[: params.blurs_per_octave - 1]
    kps = find_keypoints_octave(octave.dog_raw, octave.dog_norm, sigmas, params,
                                octave_capacity(params, 0, SIZE, SIZE))
    kps = check_descriptor_border(kps, tuple(octave.dog_raw.shape[1:]),
                                  params.descriptor_contrib_width, octave.pixel_width)
    gx_all, gy_all = ops.pixel_gradients(octave.dog_norm)
    pw = octave.pixel_width
    lam_o, lam_d = params.orientation_contrib_width, params.descriptor_contrib_width

    k1 = {"err": 0.0, "flip": 0, "n": 0, "ms": 0.0, "plain_ms": 0.0}
    k2 = {"err": 0, "raw_err": 0.0, "n": 0, "ms": 0.0, "plain_ms": 0.0}
    k5 = {"n": 0, "bytes": 0, "ms": 0.0, "plain_ms": 0.0, "launches": 0,
          "route_err": 0.0, "route_flip": 0, "route_n": 0, "route_u8": 0}
    for b in _describe_buckets(params):
        w_o, w_d = _bucket_windows(params, b)
        gx, gy = gx_all[b], gy_all[b]
        sel = kps.select(torch.nonzero(kps.mask & (kps.blur == b)).squeeze(1))
        loc, sig = sel.loc.contiguous(), sel.sigma.contiguous()

        same, (hk,) = _same_twice(
            lambda: (orientation_histograms(gx, gy, loc, sig, pw, w_o, lam_o),))
        if not same:
            fail(f"K1 is not deterministic (bucket {b})")
        hp = orientation_histograms_plain(gx, gy, loc, sig, pw, w_o, lam_o)
        err, flip = _k1_gate(hk, hp)
        k1["err"] = max(k1["err"], err)
        k1["flip"] += flip
        k1["n"] += loc.shape[0]
        k1["ms"] += cuda_ms(lambda: orientation_histograms(gx, gy, loc, sig, pw, w_o, lam_o), 20,
                            "K1")
        k1["plain_ms"] += cuda_ms(
            lambda: orientation_histograms_plain(gx, gy, loc, sig, pw, w_o, lam_o), 2, "K1 plain")

        ori = compute_orientations(gx, gy, sel, pw, params, w_max=w_o)
        ori = ori.select(torch.nonzero(ori.mask).squeeze(1))
        oloc, oth, osig = ori.loc.contiguous(), ori.theta.contiguous(), ori.sigma.contiguous()
        same, (vk,) = _same_twice(
            lambda: (descriptor_histograms(gx, gy, oloc, oth, osig, pw, lam_d, w_d),))
        if not same:
            fail(f"K2 is not deterministic (bucket {b})")
        vp = descriptor_histograms_plain(gx, gy, oloc, oth, osig, pw, lam_d, w_d)
        ones = torch.ones(oloc.shape[0], dtype=torch.bool, device=dev)
        k2["err"] = max(k2["err"], _u8_diff(descriptor_epilogue(vk, ones),
                                            descriptor_epilogue(vp, ones)))
        k2["raw_err"] = max(k2["raw_err"], float((vk - vp).abs().max()) if vk.numel() else 0.0)
        k2["n"] += oloc.shape[0]
        k2["ms"] += cuda_ms(
            lambda: descriptor_histograms(gx, gy, oloc, oth, osig, pw, lam_d, w_d), 10, "K2")
        k2["plain_ms"] += cuda_ms(
            lambda: descriptor_histograms_plain(gx, gy, oloc, oth, osig, pw, lam_d, w_d), 2,
            "K2 plain")

        # K5 on the bucket's keypoints at both windows, bit-identical
        for w, kl in ((w_o, loc), (w_d, oloc)):
            same, got = _same_twice(lambda: extract_patches(gx, gy, kl, w))
            if not same:
                fail(f"K5 is not deterministic (bucket {b}, w_max {w})")
            ref = extract_patches_plain(gx, gy, kl, w)
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                fail(f"K5 differs from its plain version (bucket {b}, w_max {w})")
            k5["n"] += kl.shape[0]
            k5["bytes"] += 2 * 2 * got[0].numel() * 4  # gx and gy, read and written
            k5["ms"] += cuda_ms(lambda: extract_patches(gx, gy, kl, w), 10, "K5")
            k5["plain_ms"] += cuda_ms(lambda: extract_patches_plain(gx, gy, kl, w), 2,
                                      "K5 plain")

        # the use_patches route (K5 + the plain histogram math) against the
        # K1 / K2 route on the same keypoints
        extract_patches.launches = 0
        hr, _ = _histogram_for_keypoints(gx, gy, loc, sig, torch.ones_like(sel.mask), pw, lam_o,
                                         w_o, use_patches=True)
        dr, _ = fill_descriptors(gx, gy, ori, pw, params, w_d, use_patches=True)
        k5["launches"] += extract_patches.launches
        err, flip = _k1_gate(hk, hr)
        k5["route_err"] = max(k5["route_err"], err)
        k5["route_flip"] += flip
        k5["route_n"] += loc.shape[0]
        k5["route_u8"] = max(k5["route_u8"], _u8_diff(dr, fill_descriptors(
            gx, gy, ori, pw, params, w_d)[0]))
        print(f"[kernels] bucket {b}: {loc.shape[0]} keypoints (K1, w={w_o}), "
              f"{oloc.shape[0]} oriented (K2, w={w_d}) on a {tuple(gx.shape)} plane")

    flip_frac = k1["flip"] / max(k1["n"], 1)
    print(f"[kernels] K1 orientation: {k1['n']} keypoints, max |kernel-plain| {k1['err']:.3e}, "
          f"outside rtol {K1_RTOL}/atol {K1_ATOL}: {k1['flip']} ({flip_frac:.4%}; atan2 bin-edge "
          f"flips, gate {K1_MAX_FLIP_FRACTION:.1%}); {k1['ms']:.4f} ms (device) vs plain "
          f"{k1['plain_ms']:.3f} ms")
    if flip_frac > K1_MAX_FLIP_FRACTION:
        fail("K1 disagrees with its plain version")
    print(f"[kernels] K2 descriptor: {k2['n']} keypoints, max |uint8 diff| {k2['err']} "
          f"(gate {K2_MAX_U8_DIFF}), raw max {k2['raw_err']:.3e}; "
          f"{k2['ms']:.3f} ms vs plain {k2['plain_ms']:.3f} ms")
    if k2["err"] > K2_MAX_U8_DIFF:
        fail("K2 disagrees with its plain version")
    route_frac = k5["route_flip"] / max(k5["route_n"], 1)
    print(f"[kernels] K5 patches: {k5['n']} keypoint windows, px/py/y0/x0 bit-identical; "
          f"{k5['ms']:.3f} ms vs plain {k5['plain_ms']:.3f} ms, "
          f"{k5['bytes'] / k5['ms'] / 1e6:.1f} GB/s patch traffic (read + written); "
          f"use_patches route vs K1: max {k5['route_err']:.3e}, outside tolerance "
          f"{k5['route_flip']} ({route_frac:.4%}), vs K2: max |uint8 diff| {k5['route_u8']}; "
          f"route launched K5 {k5['launches']} times")
    if route_frac > K1_MAX_FLIP_FRACTION or k5["route_u8"] > K2_MAX_U8_DIFF:
        fail("the use_patches route disagrees with the K1 / K2 route")
    if k5["launches"] == 0:
        fail("the use_patches route did not launch K5")
    return {
        "orientation_histograms": {"max_abs_err": k1["err"], "ms": k1["ms"],
                                   "plain_ms": k1["plain_ms"]},
        "descriptor_histograms": {"max_abs_err": float(k2["err"]), "ms": k2["ms"],
                                  "plain_ms": k2["plain_ms"]},
        "extract_patches": {"max_abs_err": 0.0, "ms": k5["ms"], "plain_ms": k5["plain_ms"],
                            "phase": "2: use_patches orientation + descriptors",
                            "launches": k5["launches"]},
    }


def _check_k4(name, k4, k3, plain):
    """K4 against K3 on the queries K3 answers, (0, 3.0e38) on the others,
    and bit-identical to its plain version.  Returns the unanswered count."""
    (i4, d4), (i3, d3), (ip, dp) = k4, k3, plain
    answered = torch.isfinite(d3)
    if not (torch.equal(i4[answered], i3[answered]) and torch.equal(d4[answered], d3[answered])):
        fail(f"K4 {name}: idx/dist differ from K3 in "
             f"{int((i4 != i3)[answered].sum())}/{int((d4 != d3)[answered].sum())} queries")
    if not ((i4[~answered] == K4_NO_MATCH[0]).all() and (d4[~answered] == K4_NO_MATCH[1]).all()):
        fail(f"K4 {name}: a query with no admissible target is not (0, 3.0e38)")
    if not (torch.equal(i4, ip) and torch.equal(d4, dp)):
        fail(f"K4 {name}: idx/dist differ from the plain version")
    return int((~answered).sum())


def phase_kernels_match(scene, dev):
    """K3 and K4 against their plain versions (and K4 against K3) on the
    scene's features at the pipeline's capacity.  Returns the records."""
    from ssrlcv_tpu.config import MatchParams, SIFTParams
    from ssrlcv_tpu_torch.core import camera_math
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.matching.match_kernel import best_target, best_target_plain
    from ssrlcv_tpu_torch.matching.match_mma import best_target_mma, best_target_mma_plain
    from ssrlcv_tpu_torch.pipeline.stages import cameras_from_refimages

    params = SIFTParams()
    f0, f1, seed_fs = (generate_features(im.pixels, params, image_id=im.id, device=dev)
                       for im in scene.images + [scene.seed_image])
    cams = cameras_from_refimages(scene.images, dev)
    mp = MatchParams(epsilon=25.0, delta=5.0)
    P = camera_math.projection_matrix(cams.cam_pos[1], cams.cam_rot[1], cams.foc[1],
                                      cams.dpix[1], cams.size[1], cams.ecef_offset[1])
    p1, p2 = camera_math.epipolar_segment_endpoints(
        f0.loc, cams.cam_pos[0], cams.cam_rot[0], cams.foc[0], cams.dpix[0], cams.size[0],
        cams.ecef_offset[0], P, mp.delta)
    inf2 = torch.full((f0.capacity, 2), torch.inf, device=dev)
    cases = {
        "seed": (f0.descriptors, seed_fs.descriptors, seed_fs.loc, inf2, inf2, 0.0, seed_fs.mask),
        "constrained": (f0.descriptors, f1.descriptors, f1.loc, p1.contiguous(),
                        p2.contiguous(), mp.epsilon, f1.mask),
    }
    k3 = {"ms": 0.0, "plain_ms": 0.0}
    k4 = {"ms": 0.0, "plain_ms": 0.0, "launches": 0}
    for name, args in cases.items():
        same, (ik, dk) = _same_twice(lambda: best_target(*args))
        if not same:
            fail(f"K3 is not deterministic ({name})")
        ip, dp = best_target_plain(*args)
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            fail(f"K3 {name}: idx/dist differ from the plain version in "
                 f"{int((ik != ip).sum())}/{int((dk != dp).sum())} queries")
        t_k = cuda_ms(lambda: best_target(*args), 5, "K3")
        t_p = cuda_ms(lambda: best_target_plain(*args), 1, "K3 plain")
        k3["ms"], k3["plain_ms"] = k3["ms"] + t_k, k3["plain_ms"] + t_p
        nq, nt = args[0].shape[0], args[1].shape[0]
        print(f"[kernels] K3 {name}: {nq} x {nt} capacity "
              f"({int(f0.mask.sum())} x {int(args[6].sum())} live), idx and dist bit-identical; "
              f"{t_k:.3f} ms vs plain {t_p:.3f} ms")

        best_target_mma.launches = 0
        k4_out = best_target_mma(*args)  # the K4 path: its entry point on these features
        k4["launches"] += best_target_mma.launches
        same, again = _same_twice(lambda: best_target_mma(*args))
        if not (same and all(torch.equal(x, y) for x, y in zip(k4_out, again))):
            fail(f"K4 is not deterministic ({name})")
        unanswered = _check_k4(name, k4_out, (ik, dk), best_target_mma_plain(*args))
        t4 = cuda_ms(lambda: best_target_mma(*args), 5, "K4")
        t4p = cuda_ms(lambda: best_target_mma_plain(*args), 1, "K4 plain")
        k4["ms"], k4["plain_ms"] = k4["ms"] + t4, k4["plain_ms"] + t4p
        print(f"[kernels] K4 {name}: {nq} x {nt} capacity, idx and dist bit-identical to K3 "
              f"and to its plain version, {unanswered} queries without an admissible target at "
              f"(0, 3.0e38); {t4:.3f} ms vs K3 {t_k:.3f} ms vs plain {t4p:.3f} ms; "
              f"{2 * nq * nt * 128 / t4 / 1e9:.1f} effective int8 TOPS")
    return {"best_target": {"max_abs_err": 0.0, **k3},
            "best_target_mma": {"max_abs_err": 0.0, **k4}}


def phase_gather(dev):
    """K6 through the patch-gather benchmark at its shapes (seed 0), then
    against its plain version."""
    from ssrlcv_tpu_torch.bench import gather_patches as G

    inp = G.make_inputs(seed=0, device=dev)
    G.patch_row_sums.launches = 0
    res = G.measure(inp)  # the benchmark's own path
    launches = G.patch_row_sums.launches
    args = (inp["packed"], inp["bi"], inp["cy"], inp["cx"], G.S)
    same, (out,) = _same_twice(lambda: (G.patch_row_sums(*args),))
    if not same:
        fail("K6 is not deterministic")
    if not torch.equal(out, G.patch_row_sums_plain(*args)):
        fail("K6 differs from its plain version")
    plain_ms = cuda_ms(lambda: G.patch_row_sums_plain(*args), 2, "K6 plain")
    print(f"[kernels] K6 patch row sums: B,H,W = {G.B},{G.H},{G.W}, K = {G.K}, S = {G.S}, "
          f"bit-identical; {res['h_ms']:.4f} ms, {res['h_gb_s']:.1f} GB/s patch traffic, vs "
          f"plain {plain_ms:.3f} ms; strategy A (multi-dim gather) {res['a_ms']:.3f} ms, "
          f"{res['a_melem_s']:.0f} Melem/s")
    if not (res["h_queued"] and res["a_queued"]):
        print("[timing] K6 benchmark: host-bound, the window includes host gaps")
    if launches == 0:
        fail("the gather benchmark did not launch K6")
    return {"patch_row_sums": {"max_abs_err": 0.0, "ms": res["h_ms"], "plain_ms": plain_ms,
                               "phase": "2: bench.gather_patches", "launches": launches}}


def phase_main_path(scene, dev):
    """Seed SIFT + run_pipeline on the card, counters reset just before."""
    from ssrlcv_tpu.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu.io import ply
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.pipeline import stages as S

    out_dir = os.path.join("out", "chip_smoke")
    cfg = PipelineConfig(output_dir=out_dir).replace(
        match=MatchParams(epsilon=25.0, delta=5.0), sift=SIFTParams())
    counters = (orientation_histograms, descriptor_histograms, best_target)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seed_fs = generate_features(scene.seed_image.pixels, cfg.sift, image_id=-1, device=dev)
    st = S.PipelineState(config=cfg, images=scene.images, seed_features=seed_fs)
    st = S.run_pipeline(st, dev)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}

    # the reconstruction's own checks; the initial cloud holds one point per
    # match (stage 3 triangulates every match before the filters)
    n_matches = len(ply.read_ply(os.path.join(out_dir, "ssrlcv-initial.ply"))["points"])
    n_points = st.matches.count()
    ba0, ba1 = st.ba_error
    filtered, _ = triangulate_matches(st.matches, S.cameras_from_refimages(scene.images, dev))
    pts = filtered.points[st.matches.mask].cpu().numpy()
    surf = scene.surface_distance_m(pts)
    truth = np.linalg.norm(pts - scene.ground_points(
        st.matches.kp_loc[st.matches.mask][:, 0].cpu().numpy()), axis=1) * 1000.0
    ba_pts = st.cloud.points[st.cloud.mask].cpu().numpy()
    print(f"[main] stages (s, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in st.stage_seconds.items()))
    print(f"[main] e2e {e2e:.3f} s (seed SIFT + pipeline); features per image "
          f"{[f.count() for f in st.features]}, seed {seed_fs.count()}")
    print(f"[main] matches {n_matches} -> points after filtering {n_points}; "
          f"BA {ba0:.6f} -> {ba1:.6f}, "
          f"ba_error_per_point {ba1 / max(n_points, 1):.6e}")
    print(f"[main] filtered cloud vs truth: median distance to the true surface "
          f"{np.median(surf):.3f} m, to the true ground points {np.median(truth):.3f} m; "
          f"BA cloud median distance to the true surface "
          f"{np.median(scene.surface_distance_m(ba_pts)):.3f} m")
    print(f"[main] launches {launches}")
    if any(v == 0 for v in launches.values()) or launches["best_target"] < 2:
        fail("a kernel of the main path was not launched")
    if n_points < MIN_POINTS:
        fail(f"reconstruction collapsed: {n_points} points")
    if not ba1 <= ba0:
        fail("BA final error exceeds the initial error")
    if not np.median(surf) <= MAX_SURFACE_MEDIAN_M:
        fail("the cloud is too far from the true surface")
    if not np.isfinite(pts).all():
        fail("non-finite points")
    # the same path again in the now warm process: the first run's stage
    # times include one-time set-up (torch.func's first trace, CUDA library
    # loads), which this rerun leaves out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seed_fs = generate_features(scene.seed_image.pixels, cfg.sift, image_id=-1, device=dev)
    warm = S.run_pipeline(S.PipelineState(config=cfg, images=scene.images,
                                          seed_features=seed_fs), dev)
    torch.cuda.synchronize()
    print(f"[main] warm rerun: stages (s, CUDA events) "
          + ", ".join(f"{k} {v:.4f}" for k, v in warm.stage_seconds.items())
          + f"; e2e {time.perf_counter() - t0:.3f} s; points {warm.matches.count()} "
          f"(first run {n_points})")
    return launches


def phase_brute(scene, dev):
    """The brute-force matching configuration on the same pair (seed SIFT +
    run_pipeline with MatchParams(mode="brute")), counters reset just
    before; then K4 on that run's two feature sets, unconstrained, against
    K3.  Returns K4's launches there."""
    from ssrlcv_tpu.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu.io import ply
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.matching.match_mma import best_target_mma, best_target_mma_plain
    from ssrlcv_tpu_torch.pipeline import stages as S

    out_dir = os.path.join("out", "chip_smoke_brute")
    cfg = PipelineConfig(output_dir=out_dir).replace(
        match=MatchParams(mode="brute", epsilon=25.0, delta=5.0), sift=SIFTParams())
    counters = (orientation_histograms, descriptor_histograms, best_target)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seed_fs = generate_features(scene.seed_image.pixels, cfg.sift, image_id=-1, device=dev)
    st = S.run_pipeline(S.PipelineState(config=cfg, images=scene.images, seed_features=seed_fs),
                        dev)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}

    n_matches = len(ply.read_ply(os.path.join(out_dir, "ssrlcv-initial.ply"))["points"])
    n_points = st.matches.count()
    ba0, ba1 = st.ba_error
    filtered, _ = triangulate_matches(st.matches, S.cameras_from_refimages(scene.images, dev))
    pts = filtered.points[st.matches.mask].cpu().numpy()
    print(f"[brute] stages (s, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in st.stage_seconds.items())
          + f"; e2e {e2e:.3f} s (seed SIFT + pipeline)")
    print(f"[brute] matches {n_matches} -> points after filtering {n_points}; "
          f"BA {ba0:.6f} -> {ba1:.6f}; filtered cloud median distance to the true surface "
          f"{np.median(scene.surface_distance_m(pts)) if len(pts) else float('nan'):.3f} m; "
          f"launches {launches}")
    if any(v == 0 for v in launches.values()) or launches["best_target"] < 2:
        fail("a kernel of the brute-force path was not launched")
    if n_points <= 0:
        fail("the brute-force path kept no points")
    if not ba1 <= ba0:
        fail("brute-force path: BA final error exceeds the initial error")

    f0, f1 = st.features
    inf2 = torch.full((f0.capacity, 2), torch.inf, device=dev)
    args = (f0.descriptors, f1.descriptors, f1.loc.contiguous(), inf2, inf2, 0.0, f1.mask)
    best_target_mma.launches = 0
    k4_out = best_target_mma(*args)
    k4_launches = best_target_mma.launches
    unanswered = _check_k4("brute", k4_out, best_target(*args), best_target_mma_plain(*args))
    print(f"[brute] K4 on the run's features ({args[0].shape[0]} x {args[1].shape[0]} capacity, "
          f"unconstrained): idx and dist bit-identical to K3 and to its plain version, "
          f"{unanswered} queries without an admissible target")
    return k4_launches


def phase_everest(dev):
    from bench import FIXTURE  # the fixture directory the JAX benchmark reads

    if not os.path.isdir(FIXTURE):
        print("[everest] skipped: the everest fixture pair is absent")
        return
    from scipy.spatial import cKDTree

    from ssrlcv_tpu.config import MatchParams, PipelineConfig
    from ssrlcv_tpu.io import refdata
    from ssrlcv_tpu_torch.core.types import FeatureSet
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.pipeline import stages as S

    fx = refdata.load_fixture_dir(FIXTURE, 2)
    sf = fx["seed_features"]
    n = len(sf["loc"])
    cap = ((n + 127) // 128) * 128
    seed = FeatureSet.empty(cap, device=dev)
    seed.loc[:n] = torch.as_tensor(sf["loc"], device=dev)
    seed.descriptors[:n] = torch.as_tensor(sf["values"], device=dev)
    seed.mask[:n] = True
    cfg = PipelineConfig(output_dir=os.path.join("out", "everest")).replace(
        match=MatchParams(epsilon=25.0, delta=5.0))
    st = S.run_pipeline(S.PipelineState(config=cfg, images=fx["images"], seed_features=seed), dev)
    pc, _ = triangulate_matches(st.matches, S.cameras_from_refimages(fx["images"], dev))
    d, _ = cKDTree(fx["points0"]).query(pc.points[st.matches.mask].cpu().numpy())
    print(f"[everest] points {st.matches.count()} (JAX record 13479), cloud_vs_golden_m "
          f"{float(np.median(d)) * 1000.0:.3f} (JAX record 0.034), BA {st.ba_error}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        raise SystemExit(1)
    try:
        from ssrlcv_tpu_torch.synthetic import make_scene
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repo ({e})", file=sys.stderr)
        raise SystemExit(1)

    dev = torch.device("cuda:0")
    phase_env()
    phase_build()
    t0 = time.perf_counter()
    scene = make_scene(SEED, SIZE)
    print(f"[scene] synthetic pair + seed image at {SIZE}^2 (seed {SEED}) in "
          f"{time.perf_counter() - t0:.2f} s")

    recs = {**phase_kernels_features(scene, dev), **phase_kernels_match(scene, dev),
            **phase_gather(dev)}
    launches = phase_main_path(scene, dev)
    for name in launches:
        recs[name].update(phase="3: main path", launches=launches[name])
    recs["best_target_mma"].update(
        phase="2 + 3b: best_target_mma on the main path's and the brute path's features",
        launches=recs["best_target_mma"]["launches"] + phase_brute(scene, dev))
    phase_everest(dev)

    if "jax" in sys.modules:
        fail("jax was imported")
    sources = {
        "orientation_histograms": ("csrc/orient.cu", "ssrlcv_tpu/features/orient_kernel.py:57"),
        "descriptor_histograms": ("csrc/desc.cu", "ssrlcv_tpu/features/desc_kernel.py:77"),
        "best_target": ("csrc/match.cu", "ssrlcv_tpu/matching/pallas_match.py:129"),
        "best_target_mma": ("csrc/match_mma.cu", "ssrlcv_tpu/matching/pallas_match.py:39"),
        "extract_patches": ("csrc/patches.cu", "ssrlcv_tpu/features/patches.py:47"),
        "patch_row_sums": ("csrc/gather.cu", "scripts/bench_gather2.py:139"),
    }
    kernels = [{"name": name, "route": "cuda", "source": f"ssrlcv_tpu_torch/{src}",
                "replaces": rep, **recs[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
