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
     (ssrlcv_tpu_torch.bench.gather_patches); the blur kernel
     (csrc/blur.cu) over octave 0's blur chain of image 0 (2048^2, the six
     tap counts), bit-identical to its plain version; the detection kernels
     (csrc/detect.cu) on every octave of image 0, bit-identical to the plain
     chain; tolerances below;
  3. the 2-view main path through ssrlcv_tpu_torch.pipeline.stages on
     cuda:0 (seed SIFT + run_pipeline), with per-stage CUDA-event times, the
     reconstruction's own checks (points, BA error, distance to the scene's
     true surface) and the kernels' launch counters; then the same path once
     more, warm, for its stage times without one-time set-up;
  3b. the same pair in the brute-force matching configuration
     (MatchParams(mode="brute")), then K4 on that run's two feature sets
     against K3;
  3c. bundle adjustment's other modes on phase 3's filtered matches:
     "newton" (final error not above initial) and "reference" (no update);
  4. the everest fixture pair, only where the environment variable
     SSRLCV_EVEREST_FIXTURE names the reference's
     test/checkpoints/Pipeline2View directory;
  5. the command line (ssrlcv_tpu_torch.pipeline.sfm.main, in process) on
     the scene's three views written as a directory with params.csv, with
     checkpoints: stage times, tracks by view count, BA error, the
     reconstruction's checks; then again with the stage-5 marker deleted,
     which must resume at stage 5 and launch no kernel;
  6. the command line with --pose on the 2-view pair of phase 3;
  7. dense and stereo on image 0 of the scene at 1024^2: 7a dense SIFT's
     fast path (stencil orientation field, compaction, one K2 launch over
     every dense keypoint; a warm call split into its parts; K2 alone
     against its bound and, on the first 65,536 keypoints, its plain
     version); 7b the gather oracle (K1 over every interior pixel, then K2)
     against 7a by slot; 7c Window_NxN features, SAD best target on a
     shifted crop and SAD epipolar matching on the card against the CPU;
     7d the scanline stereo search on a shifted copy and the epipolar one;
     7e FAST on the card against the CPU;
  8. pushbroom cameras: the pair as a directory whose params.csv holds
     pushbroom rows, through seed SIFT + run_pipeline on the card in mode
     "brute" (K1, K2, K3), its stage-3 and stage-4 clouds against the CPU
     port's triangulation and filters on the same matches (counts equal,
     points within the float32 bound of ROADMAP.md caveat m), stage 5's NaN
     errors against the CPU's;
  9. on phase 3's state: the planar filter, the octree, normals and the
     low-density filter, reconstruct_surface (resolution 64 on the card, held
     against the CPU port at 32) and the three octree-lattice meshers (depth
     6) against the CPU port, the plane
     estimate, debug clouds and a mesh written and read back, and the
     reference features of tests/data through features_from_refdata and
     seed_distances (K3) against the plain version;
 10. the multi-device stages (ssrlcv_tpu_torch.parallel): 10a the main
     path's pair through run_pipeline(mesh=...) in this process over a
     1 x 1 mesh of a one-rank NCCL group; 10b the same in 2 spawned processes
     on cuda:0, a gloo group and a 2 x 1 mesh (K1 and K2 on each rank's
     image, K3 on each rank's query shard); each held to phase 3's filtered
     matches and initial cloud (equal), and its BA final error (rtol 1e-3)
     to phase 3's for 10a, to a plain reference summing the same two track
     blocks for 10b (and to phase 3's within the order spread, rtol 2e-2);
     each rank's stage seconds.  One card gives no evidence of NCCL
     scale-out.
 11. the measurement drivers (ssrlcv_tpu_torch.bench.{reconstruct,
     profile_sift, match_kernel, nview, pose, dense, scaling} and
     ssrlcv_tpu_torch.tester), each main in this process on the scene above
     (reconstruct with --reps 1), its record printed on a [bench] line:
     each record names the card and its kernels launched; reconstruct's
     points and BA final error equal phase 3's (the same steps), with
     bench.py's gates and the true-surface bound; profile_sift's parts
     within generate_features' e2e time, and its marked call within
     PROFILE_RTOL of that time; the tester (which renders its own scene,
     as a user's run does) logs its start / end rows and a heartbeat;
     dense's features equal phase 7a's; nview's tracks and pose's
     post-pose matches printed beside phases 5 and 6, and pose's record
     times nothing where no pair passes the pose thresholds.

Kernel times are device times from CUDA events over back-to-back launches
queued behind a device-side sleep (ssrlcv_tpu_torch.bench.timing).  Each
path that runs a kernel sets its launch counters to 0 just before and reads
them just after; launches made only to compare a kernel with its plain
version are not counted.

The command-line phases read what a user of the command line gets: the
PLY files, the stage checkpoints and the log (stage seconds from CUDA
events, host-clock phases, the BA error).

Exits non-zero on any failure, and at once, printing no result, when no CUDA
device is available or the script is not run from the root of a checkout.
The second-to-last line is a JSON object of the kernels' measurements; the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import os
import shutil
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
# profile_sift: generate_features with marks and without, each the least of
# five host-clock runs taken alternately, may differ by this share; the
# parts' sum may exceed the unmarked e2e time by it.  Two such readings of
# one function came 0.9 % apart on the card (0.1751 / 0.1766 s), a copy of
# the function that had drifted 12 % (0.1785 / 0.1587 s): this separates them
PROFILE_RTOL = 0.10
# fp32 operations per window sample: K1 magnitude, exp, atan2, bin and add
# (~40); K2 ~40 of its own (rotation, rint, magnitude, exp, atan2, fmod)
# plus ~8 for each of the ~4 cells x 2 bins it feeds
K1_OPS_PER_SAMPLE = 40
K2_OPS_PER_SAMPLE = 100


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
    name = smi.splitlines()[0].rsplit(",", 1)[0].strip()
    from ssrlcv_tpu_torch import _cuda

    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return name


def phase_build():
    from ssrlcv_tpu_torch import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    built = _cuda.build_seconds
    print(f"[build] {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s"
          + (f" (nvcc {built:.2f} s)" if built is not None else " (already built)"))


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the least time for ``nbytes`` of traffic and
    ``ops`` operations of type ``kind`` ("fp32" or "int8") at the H100's
    published peaks (ssrlcv_tpu_torch.bench.scene)."""
    from ssrlcv_tpu_torch.bench import scene as SC

    peak = {"fp32": SC.H100_FP32_PER_S, "int8": SC.H100_INT8_PER_S}[kind]
    tb, to = nbytes / SC.H100_BYTES_PER_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _k1_samples(sig, pw, lam_o, w_max) -> int:
    """Window samples K1 evaluates: (2 min(win, w_max) + 1)^2 per keypoint."""
    from ssrlcv_tpu_torch.features.orient_kernel import window_and_denom

    r = torch.clamp(window_and_denom(sig, pw, lam_o)[0], max=w_max)
    return int(((2 * r + 1) ** 2).sum())


def _k2_samples(theta, sig, pw, lam_d, w_max, chunk: int = 1024) -> int:
    """Window samples K2 evaluates: lattice offsets |dx|,|dy| <= min(win,
    w_max) whose rotation lies within the window, per keypoint."""
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_window

    win = descriptor_window(sig, pw, lam_d)
    offs = torch.arange(-w_max, w_max + 1, device=sig.device, dtype=torch.float32)
    dy, dx = (g.reshape(-1) for g in torch.meshgrid(offs, offs, indexing="ij"))
    n = 0
    for s0 in range(0, sig.shape[0], chunk):
        wc = win[s0:s0 + chunk, None]
        ct, st = torch.cos(theta[s0:s0 + chunk, None]), torch.sin(theta[s0:s0 + chunk, None])
        cx, cy = dx * ct - dy * st, dx * st + dy * ct
        n += int(((dx.abs() <= wc) & (dy.abs() <= wc) & (cx.abs() <= wc)
                  & (cy.abs() <= wc)).sum())
    return n


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
    from ssrlcv_tpu_torch.config import SIFTParams
    from ssrlcv_tpu_torch.features import scale_space as ss
    from ssrlcv_tpu_torch.features.desc_kernel import (descriptor_histograms,
                                                       descriptor_histograms_plain)
    from ssrlcv_tpu_torch.features.descriptor import descriptor_epilogue, fill_descriptors
    from ssrlcv_tpu_torch.features.detector import find_keypoints_octave
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
                                octave_capacity(params, 0, SIZE, SIZE), octave.pixel_width)
    gx_all, gy_all = ops.pixel_gradients(octave.dog_norm)
    pw = octave.pixel_width
    lam_o, lam_d = params.orientation_contrib_width, params.descriptor_contrib_width

    k1 = {"err": 0.0, "flip": 0, "n": 0, "ms": 0.0, "plain_ms": 0.0, "samples": 0, "io": 0}
    k2 = {"err": 0, "raw_err": 0.0, "n": 0, "ms": 0.0, "plain_ms": 0.0, "samples": 0, "io": 0}
    k5 = {"n": 0, "bytes": 0, "ms": 0.0, "plain_ms": 0.0, "launches": 0, "io": 0,
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
        k1["samples"] += _k1_samples(sig, pw, lam_o, w_o)
        k1["io"] += _nbytes(gx, gy, loc, sig, hk)
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
        k2["samples"] += _k2_samples(oth, osig, pw, lam_d, w_d)
        k2["io"] += _nbytes(gx, gy, oloc, oth, osig, vk)
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
            k5["io"] += _nbytes(gx, gy, kl, *got)
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
    b1 = bound(k1["io"], k1["samples"] * K1_OPS_PER_SAMPLE, "fp32")
    b2 = bound(k2["io"], k2["samples"] * K2_OPS_PER_SAMPLE, "fp32")
    b5 = bound(k5["io"], 0, "fp32")
    print(f"[kernels] bounds: K1 {b1['bound_ms']:.4f} ms ({b1['bound_by']}; {k1['samples']} "
          f"window samples), K2 {b2['bound_ms']:.4f} ms ({b2['bound_by']}; {k2['samples']} "
          f"window samples), K5 {b5['bound_ms']:.4f} ms ({b5['bound_by']})")
    return {
        "orientation_histograms": {"max_abs_err": k1["err"], "ms": k1["ms"],
                                   "plain_ms": k1["plain_ms"], **b1, "library_ms": None},
        "descriptor_histograms": {"max_abs_err": float(k2["err"]), "ms": k2["ms"],
                                  "plain_ms": k2["plain_ms"], **b2, "library_ms": None},
        "extract_patches": {"max_abs_err": 0.0, "ms": k5["ms"], "plain_ms": k5["plain_ms"],
                            "phase": "2: use_patches orientation + descriptors",
                            "launches": k5["launches"], **b5, "library_ms": None},
    }


def phase_kernels_blur(scene, dev):
    """The blur kernel against its plain version over octave 0's blur chain
    of image 0: each blur's input is the previous blur's output, as in
    build_scale_space.  Returns its record."""
    from ssrlcv_tpu_torch.config import SIFTParams
    from ssrlcv_tpu_torch.features import scale_space as ss
    from ssrlcv_tpu_torch.ops import image_ops as ops

    params = SIFTParams()
    cur = ops.upsample2x(ops.to_float(torch.as_tensor(scene.images[0].pixels, device=dev)))
    pw = 2.0 ** params.starting_octave
    rec = {"ms": 0.0, "plain_ms": 0.0, "io": 0, "by_taps": {}}
    for sigma in ss.octave_sigmas(params, 0):
        taps = ops.gaussian_kernel_1d(sigma, pw, params.kernel_size[0])
        x = cur
        same, (cur,) = _same_twice(lambda: (ops.convolve_separable_symmetric(x, taps),))
        if not same:
            fail(f"the blur kernel is not deterministic ({len(taps)} taps)")
        if not torch.equal(cur, ops.convolve_separable_symmetric_plain(x, taps)):
            fail(f"the blur kernel differs from its plain version ({len(taps)} taps)")
        ms = cuda_ms(lambda: ops.convolve_separable_symmetric(x, taps), 20, "blur")
        plain_ms = cuda_ms(lambda: ops.convolve_separable_symmetric_plain(x, taps), 2,
                           "blur plain")
        io = 4 * _nbytes(x)  # each pass reads and writes the plane once
        rec["by_taps"][len(taps)] = {"ms": ms, "plain_ms": plain_ms,
                                     **bound(io, 0, "fp32")}
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        rec["io"] += io
    b = bound(rec.pop("io"), 0, "fp32")
    print(f"[kernels] blur: octave 0 chain on a {tuple(cur.shape)} plane, bit-identical; "
          f"{rec['ms']:.4f} ms (device) vs plain {rec['plain_ms']:.3f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); by tap count "
          + ", ".join(f"{k}: {v['ms']:.4f} / {v['bound_ms']:.4f} / {v['plain_ms']:.3f} ms"
                      for k, v in rec["by_taps"].items()))
    return {"convolve_separable_symmetric": {"max_abs_err": 0.0, **rec, **b,
                                             "library_ms": None}}


def phase_kernels_detect(scene, dev):
    """The detection kernels against the plain chain (find_keypoints_octave_plain,
    then check_descriptor_border) on every octave of image 0: every slot of
    the capacity equal to the bit, deterministic; the extrema and the
    keypoint kernel timed alone.  Returns its record."""
    from ssrlcv_tpu_torch.config import SIFTParams
    from ssrlcv_tpu_torch.features import detect_kernel as DK
    from ssrlcv_tpu_torch.features import detector as D
    from ssrlcv_tpu_torch.features import scale_space as ss
    from ssrlcv_tpu_torch.features.sift import octave_capacity

    params = SIFTParams()
    px = torch.as_tensor(scene.images[0].pixels, device=dev)
    thr = params.noise_threshold * 0.8
    rec = {"ms": 0.0, "plain_ms": 0.0, "io": 0, "keypoints": 0, "by_octave": {}}
    for o, octave in enumerate(ss.build_scale_space(px, params, SIZE, SIZE)):
        raw, norm, pw = octave.dog_raw, octave.dog_norm, octave.pixel_width
        sigmas = tuple(ss.octave_sigmas(params, o))[: params.blurs_per_octave - 1]
        cap = octave_capacity(params, o, SIZE, SIZE)
        same, got = _same_twice(
            lambda: tuple(D.find_keypoints_octave(raw, norm, sigmas, params, cap, pw)))
        if not same:
            fail(f"the detection kernels are not deterministic (octave {o})")

        def plain():
            kps = D.find_keypoints_octave_plain(raw, norm, sigmas, params, cap)
            return D.check_descriptor_border(kps, tuple(raw.shape[1:]),
                                             params.descriptor_contrib_width, pw)

        if not all(torch.equal(a, b) for a, b in zip(got, plain())):
            fail(f"the detection kernels differ from the plain chain (octave {o})")
        flags = DK.extrema_flags(raw, thr)
        found = torch.nonzero(flags).squeeze(1)[:cap].contiguous()
        ext_ms = cuda_ms(lambda: DK.extrema_flags(raw, thr), 20, "detect extrema")
        kp_ms = cuda_ms(lambda: DK.keypoint_slots(raw, norm, found, sigmas, params, cap, pw), 20,
                        "detect keypoints")
        plain_ms = cuda_ms(plain, 2, "detect plain")
        # dog_raw read once, the flags written, the kept extrema read, the
        # slots written (blur 8, loc 8, intensity, sigma, theta 4 each, mask 1)
        io = _nbytes(raw, flags, found) + cap * 29
        kept = int(got[5].sum())
        rec["by_octave"][o] = {"extrema_ms": ext_ms, "keypoints_ms": kp_ms, "plain_ms": plain_ms,
                               "extrema": int(flags.sum()), "slots": cap, "keypoints": kept,
                               **bound(io, 0, "fp32")}
        rec["ms"] += ext_ms + kp_ms
        rec["plain_ms"] += plain_ms
        rec["io"] += io
        rec["keypoints"] += kept
    b = bound(rec.pop("io"), 0, "fp32")
    print(f"[kernels] detect: {len(rec['by_octave'])} octaves of image 0, bit-identical; "
          f"{rec['ms']:.4f} ms (device, both kernels) vs plain {rec['plain_ms']:.3f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); by octave (extrema / keypoints / bound / "
          "plain ms) " + ", ".join(
              f"{o}: {v['extrema_ms']:.4f} / {v['keypoints_ms']:.4f} / {v['bound_ms']:.4f} / "
              f"{v['plain_ms']:.3f}" for o, v in rec["by_octave"].items()))
    return {"detect_keypoints": {"max_abs_err": 0.0, **rec, **b, "library_ms": None}}


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


def _library_best(q_desc, q_mask, t_desc, t_mask):
    """The library yardstick of K3 / K4, unconstrained: cuBLAS's int8
    product of the centred live descriptors (torch._int_mm), then the row
    minimum of |t|^2 - 2 q.t (two calls and their elementwise step).
    Returns (the call, |q|^2 of the live queries)."""
    def centred(desc, mask):
        c = (desc[mask].to(torch.int16) - 128).to(torch.int8)
        pad = -c.shape[0] % 8  # _int_mm wants multiples of 8: repeat the last row
        return torch.cat([c, c[-1:].expand(pad, -1)]) if pad else c

    q8, t8 = centred(q_desc, q_mask), centred(t_desc, t_mask)
    tn = (t8.int() ** 2).sum(1, dtype=torch.int32)
    qn = (q8.int() ** 2).sum(1, dtype=torch.int32)[:int(q_mask.sum())]
    return lambda: torch.min(tn[None, :] - 2 * torch._int_mm(q8, t8.t()), dim=1), qn


def _gated_pairs(q_mask, t_valid, p1, p2, t_loc, eps) -> int:
    """(query, target) pairs the gate admits (the epipolar test, or every
    target for a row with p1.x not finite) among the queries of ``q_mask``
    and the targets of ``t_valid``: the pairs whose distance the pass
    needs."""
    from ssrlcv_tpu_torch.matching.match_kernel import epipolar_segment_mask

    rows = torch.nonzero(q_mask).squeeze(1)
    n = 0
    for s0 in range(0, rows.shape[0], 1024):
        r = rows[s0:s0 + 1024]
        gate = epipolar_segment_mask(p1[r], p2[r], t_loc, eps) | ~torch.isfinite(p1[r, 0:1])
        n += int((gate & t_valid[None, :]).sum())
    return n


def _evaluated_pairs(t_loc, t_valid, p1, p2, eps, q_valid) -> int:
    """Pairs in the (16-row, 128-target) tiles that K3 (and, with q_valid
    None and the admissible targets, K4) evaluates after its tile skip."""
    from ssrlcv_tpu_torch.matching.match_kernel import live_tiles, spatial_order, tile_boxes

    perms = spatial_order(t_loc, t_valid, p1, p2, q_valid)
    live = live_tiles(*tile_boxes(t_loc, p1, p2, eps, t_valid, q_valid, *perms))
    return int(live.sum()) * 16 * 128


def phase_kernels_match(scene, dev):
    """K3 (with and without q_valid) and K4 against their plain versions
    (and K4 against K3) on the scene's features at the pipeline's capacity,
    with the library yardstick on the seed pass.  Returns the records."""
    from ssrlcv_tpu_torch.config import MatchParams, SIFTParams
    from ssrlcv_tpu_torch.core import camera_math
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.matching.match_kernel import best_target, best_target_plain
    from ssrlcv_tpu_torch.matching.match_mma import (admissible, best_target_mma,
                                                     best_target_mma_plain)
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
    p1, p2 = p1.contiguous(), p2.contiguous()
    inf2 = torch.full((f0.capacity, 2), torch.inf, device=dev)
    live = int(f0.mask.sum())
    every_row = torch.ones_like(f0.mask)
    cases = {
        "seed": (f0.descriptors, seed_fs.descriptors, seed_fs.loc, inf2, inf2, 0.0,
                 seed_fs.mask),
        "constrained": (f0.descriptors, f1.descriptors, f1.loc, p1, p2, mp.epsilon, f1.mask),
    }
    k3 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "no_q_valid_ms": 0.0, "io": 0,
          "ops": 0}
    k4 = {"ms": 0.0, "plain_ms": 0.0, "launches": 0, "io": 0, "ops": 0}
    for name, args in cases.items():
        # K3 answers the live rows (q_valid), K4 every row of the capacity
        pairs = _gated_pairs(f0.mask, args[6], args[3], args[4], args[2], args[5])
        adm = admissible(args[2], args[6])
        pairs4 = _gated_pairs(every_row, adm, args[3], args[4], args[2], args[5])
        qv = {"q_valid": f0.mask}  # as the main path calls it
        # without q_valid (every row answered), then with it
        same, (ia, da) = _same_twice(lambda: best_target(*args))
        if not same:
            fail(f"K3 is not deterministic ({name}, no q_valid)")
        ip, dp = best_target_plain(*args)
        if not (torch.equal(ia, ip) and torch.equal(da, dp)):
            fail(f"K3 {name} (no q_valid): idx/dist differ from the plain version in "
                 f"{int((ia != ip).sum())}/{int((da != dp).sum())} queries")
        same, (ik, dk) = _same_twice(lambda: best_target(*args, **qv))
        if not same:
            fail(f"K3 is not deterministic ({name})")
        ipv, dpv = best_target_plain(*args, **qv)
        if not (torch.equal(ik, ipv) and torch.equal(dk, dpv)):
            fail(f"K3 {name}: idx/dist differ from the plain version in "
                 f"{int((ik != ipv).sum())}/{int((dk != dpv).sum())} queries")
        t_k = cuda_ms(lambda: best_target(*args, **qv), 10, "K3")
        t_a = cuda_ms(lambda: best_target(*args), 10, "K3 without q_valid")
        t_p = cuda_ms(lambda: best_target_plain(*args, **qv), 1, "K3 plain")
        lib, qn = _library_best(args[0], f0.mask, args[1], args[6])
        if name == "seed":  # the yardstick computes the same function here
            got = (qn + lib()[0][:qn.shape[0]]).float()
            if not torch.equal(got, dk[f0.mask]):
                fail("the library yardstick disagrees with K3 on the seed pass")
        t_l = cuda_ms(lib, 3, "library")
        del lib
        io = _nbytes(*args[:5], args[6], f0.mask, ik, dk)
        evaluated = _evaluated_pairs(args[2], args[6], args[3], args[4], args[5], f0.mask)
        b = bound(io, 2 * 128 * pairs, "int8")
        for key, v in (("ms", t_k), ("no_q_valid_ms", t_a), ("plain_ms", t_p),
                       ("library_ms", t_l), ("io", io), ("ops", 2 * 128 * pairs)):
            k3[key] += v
        nq, nt = args[0].shape[0], args[1].shape[0]
        print(f"[kernels] K3 {name}: {nq} x {nt} capacity ({live} x {int(args[6].sum())} live, "
              f"{pairs} pairs needing a distance, {evaluated} in the tiles evaluated), idx "
              f"and dist bit-identical with and "
              f"without q_valid; {t_k:.4f} ms ({t_a:.4f} ms without q_valid) vs plain "
              f"{t_p:.3f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); library "
              f"(_int_mm + min, live rows, ungated) {t_l:.3f} ms")

        best_target_mma.launches = 0
        k4_out = best_target_mma(*args)  # the K4 path: its entry point on these features
        k4["launches"] += best_target_mma.launches
        same, again = _same_twice(lambda: best_target_mma(*args))
        if not (same and all(torch.equal(x, y) for x, y in zip(k4_out, again))):
            fail(f"K4 is not deterministic ({name})")
        unanswered = _check_k4(name, k4_out, (ia, da), best_target_mma_plain(*args))
        t4 = cuda_ms(lambda: best_target_mma(*args), 5, "K4")
        t4p = cuda_ms(lambda: best_target_mma_plain(*args), 1, "K4 plain")
        io4 = _nbytes(*args[:5], args[6], *k4_out)
        evaluated4 = _evaluated_pairs(args[2], adm, args[3], args[4], args[5], None)
        b4 = bound(io4, 2 * 128 * pairs4, "int8")
        for key, v in (("ms", t4), ("plain_ms", t4p), ("io", io4), ("ops", 2 * 128 * pairs4)):
            k4[key] += v
        print(f"[kernels] K4 {name}: {nq} x {nt} capacity (every row, {int(adm.sum())} "
              f"admissible targets, {pairs4} pairs needing a distance, {evaluated4} in the tiles "
              f"evaluated), idx and dist bit-identical to K3 and to its plain version, "
              f"{unanswered} queries without an admissible target at (0, 3.0e38); {t4:.4f} ms vs "
              f"K3 {t_a:.4f} ms (no q_valid) vs plain {t4p:.3f} ms; bound {b4['bound_ms']:.4f} ms "
              f"({b4['bound_by']}); {2 * 128 * pairs4 / t4 / 1e9:.1f} int8 TOPS on the pairs "
              f"needed")
    b3 = bound(k3.pop("io"), k3.pop("ops"), "int8")
    b4 = bound(k4.pop("io"), k4.pop("ops"), "int8")
    return {"best_target": {"max_abs_err": 0.0, **k3, **b3},
            "best_target_mma": {"max_abs_err": 0.0, **k4, **b4,
                                "library_ms": k3["library_ms"]}}


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
    # K6's parts (memset, key lists, band kernel): device time per call
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            G.patch_row_sums(*args)
        torch.cuda.synchronize()
    parts = {e.key.replace("(anonymous namespace)::", "").split("(")[0].strip():
             e.device_time_total / e.count
             for e in prof.key_averages() if e.device_time_total > 0}
    print("[kernels] K6 parts (us a call, torch.profiler): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(f"[kernels] K6 patch row sums: B,H,W = {G.B},{G.H},{G.W}, K = {G.K}, S = {G.S}, "
          f"bit-identical; {res['h_ms']:.4f} ms, {res['h_gb_s']:.1f} GB/s over the bytes it must "
          f"move (the plane under the keys' patches, the keys, the output), vs "
          f"plain {plain_ms:.3f} ms; strategy A (multi-dim gather) {res['a_ms']:.3f} ms, "
          f"{res['a_melem_s']:.0f} Melem/s")
    if not (res["h_queued"] and res["a_queued"]):
        print("[timing] K6 benchmark: host-bound, the window includes host gaps")
    if launches == 0:
        fail("the gather benchmark did not launch K6")
    # the bytes under the keys' patches, not of the whole (B, H, W) tensor
    b6 = bound(G.function_bytes(*args), 0, "fp32")
    return {"patch_row_sums": {"max_abs_err": 0.0, "ms": res["h_ms"], "plain_ms": plain_ms,
                               "phase": "2: bench.gather_patches", "launches": launches,
                               **b6, "library_ms": None}}


def phase_main_path(scene, dev):
    """Seed SIFT + run_pipeline on the card, counters reset just before."""
    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.io import ply
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.detect_kernel import detect_keypoints
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.ops.image_ops import convolve_separable_symmetric
    from ssrlcv_tpu_torch.pipeline import stages as S

    out_dir = os.path.join("out", "chip_smoke")
    cfg = PipelineConfig(output_dir=out_dir).replace(
        match=MatchParams(epsilon=25.0, delta=5.0), sift=SIFTParams())
    counters = (orientation_histograms, descriptor_histograms, best_target,
                convolve_separable_symmetric, detect_keypoints)
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
    return launches, st


def phase_brute(scene, dev):
    """The brute-force matching configuration on the same pair (seed SIFT +
    run_pipeline with MatchParams(mode="brute")), counters reset just
    before; then K4 on that run's two feature sets, unconstrained, against
    K3.  Returns K4's launches there."""
    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.io import ply
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
    return launches, k4_launches


def phase_ba_modes(st, scene, dev):
    """Bundle adjustment in modes "newton" and "reference" on phase 3's
    filtered matches and input cameras."""
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust
    from ssrlcv_tpu_torch.pipeline import stages as S

    cams = S.cameras_from_refimages(scene.images, dev)
    for mode in ("newton", "reference"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = bundle_adjust(st.matches, cams, st.config.ba, mode=mode)
        e0, e1 = float(r.initial_error), float(r.final_error)
        print(f"[ba-modes] {mode}: BA {e0:.6f} -> {e1:.6f} in {time.perf_counter() - t0:.3f} s "
              f"(host clock); {int(r.cloud.mask.sum())} points")
        if mode == "newton" and not e1 <= e0:
            fail("BA newton: final error exceeds the initial error")
        if mode == "reference" and e1 != e0:
            fail("BA reference: the error changed")
        if not torch.isfinite(r.cloud.points[r.cloud.mask]).all():
            fail(f"BA {mode}: non-finite points")


def _read_log(path: str, start: int):
    """The log rows written from byte ``start`` on, split into (tag, text)."""
    with open(path) as f:
        f.seek(start)
        return [tuple(line.rstrip("\n").split(",", 2)[1:]) for line in f if line.count(",") >= 2]


def _log_value(rows, prefix):
    """The text after ``prefix`` of the last info row that starts with it."""
    hits = [text[len(prefix):] for tag, text in rows if tag == "info" and text.startswith(prefix)]
    if not hits:
        fail(f"the command line logged no '{prefix}' line")
    return hits[-1]


def _cli(argv, out_dir, counters):
    """sfm.main(argv) in process, the kernels' counters reset just before;
    returns (launches, host seconds, the log rows of this run)."""
    from ssrlcv_tpu_torch.pipeline import sfm

    log = os.path.join(out_dir, "ssrlcv.log")
    start = os.path.getsize(log) if os.path.exists(log) else 0
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = sfm.main(argv + ["-o", out_dir, "--device", "cuda:0"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        fail(f"the command line returned {rc}")
    return {fn.__name__: fn.launches for fn in counters}, seconds, _read_log(log, start)


def _cli_report(tag, rows, seconds, launches):
    """Print a command-line run's stage seconds, host-clock phases and BA
    error; returns (stage seconds, (BA initial, BA final))."""
    stages = json.loads(_log_value(rows, "stage seconds "))
    took = [text for tag_, text in rows if tag_ == "info" and " took " in text]
    ba = tuple(float(x) for x in _log_value(rows, "bundle adjust: ").split("(")[0].split("->"))
    print(f"[{tag}] stages (s, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; host clock: {'; '.join(took)}; main() {seconds:.3f} s")
    print(f"[{tag}] BA {ba[0]!r} -> {ba[1]!r}; launches {launches}")
    return stages, ba


def _ply(out_dir, name):
    from ssrlcv_tpu_torch.io import ply

    path = os.path.join(out_dir, f"{name}.ply")
    if not os.path.exists(path):
        fail(f"{path} was not written")
    return ply.read_ply(path)["points"]


def phase_cli_nview(scene3, counters):
    """The command line on the three views, then resumed at stage 5."""
    from ssrlcv_tpu_torch.synthetic import write_scene_dir

    root = os.path.join("out", "chip_smoke_cli", "three_views")
    shutil.rmtree(root, ignore_errors=True)
    seed = write_scene_dir(scene3, os.path.join(root, "images"))
    out, ckpt = os.path.join(root, "out"), os.path.join(root, "ckpt")
    argv = ["-d", os.path.join(root, "images"), "-s", seed, "--epsilon", "25", "--delta", "5",
            "-cpdir", ckpt]
    launches, seconds, rows = _cli(argv, out, counters)
    _, ba = _cli_report("cli-3", rows, seconds, launches)
    with np.load(os.path.join(ckpt, "sfm-stage4", "state.npz")) as z:
        views = z["matches.num_views"][z["matches.mask"]]
    tracks = {int(v): int((views == v).sum()) for v in np.unique(views)}
    pts = _ply(out, "ssrlcv-BA-final")
    surf = np.median(scene3.surface_distance_m(pts)) if len(pts) else float("nan")
    n_initial, n_filtered = len(_ply(out, "ssrlcv-initial")), len(_ply(out, "ssrlcv-filtered"))
    print(f"[cli-3] tracks {n_initial} -> {n_filtered} after filtering, by view count {tracks}; "
          f"BA cloud median distance to the true surface {surf:.3f} m")
    # the seed pass of stage 2, one per query image of the pair sweep, one
    # per pair
    want_k3 = 1 + 2 + 3
    if launches["orientation_histograms"] == 0 or launches["descriptor_histograms"] == 0:
        fail("the command line did not launch K1 / K2")
    if launches["best_target"] != want_k3:
        fail(f"the command line launched K3 {launches['best_target']} times, not {want_k3}")
    if n_filtered < MIN_POINTS:
        fail(f"N-view reconstruction collapsed: {n_filtered} tracks after filtering")
    if not ba[1] <= ba[0]:
        fail("N-view BA final error exceeds the initial error")
    if not np.isfinite(pts).all():
        fail("non-finite points in the N-view BA cloud")
    if not surf <= MAX_SURFACE_MEDIAN_M:
        fail("the N-view cloud is too far from the true surface")

    os.remove(os.path.join(ckpt, "sfm-stage5", "done"))
    again, seconds, rows = _cli(argv, out, counters)
    _, ba2 = _cli_report("cli-3 resumed", rows, seconds, again)
    if _log_value(rows, "resuming at stage ") != "5":
        fail("the command line did not resume at stage 5")
    if any(again.values()):
        fail(f"the resumed run launched kernels: {again}")
    if abs(ba2[1] - ba[1]) > 1e-5 * abs(ba[1]):
        fail(f"the resumed BA error {ba2[1]!r} differs from the first run's {ba[1]!r}")
    return launches, {"tracks": n_initial, "filtered_tracks": n_filtered}


def phase_cli_pose(scene, counters):
    """The command line with --pose on the phase-3 pair."""
    from ssrlcv_tpu_torch.synthetic import write_scene_dir

    root = os.path.join("out", "chip_smoke_cli", "two_views_pose")
    shutil.rmtree(root, ignore_errors=True)
    seed = write_scene_dir(scene, os.path.join(root, "images"))
    out, ckpt = os.path.join(root, "out"), os.path.join(root, "ckpt")
    argv = ["-d", os.path.join(root, "images"), "-s", seed, "--epsilon", "25", "--delta", "5",
            "-cpdir", ckpt, "--pose"]
    launches, seconds, rows = _cli(argv, out, counters)
    stages, ba = _cli_report("cli-pose", rows, seconds, launches)
    cams = []
    for stage in (0, 1):
        with np.load(os.path.join(ckpt, f"sfm-stage{stage}", "state.npz")) as z:
            cams.append((z["cameras.cam_pos"], z["cameras.cam_rot"]))
    moved = np.abs(cams[1][1][1] - cams[0][1][1])
    pts = _ply(out, "ssrlcv-BA-final")
    surf = np.median(scene.surface_distance_m(pts)) if len(pts) else float("nan")
    print(f"[cli-pose] camera 1 rotation {cams[0][1][1].tolist()} -> {cams[1][1][1].tolist()} "
          f"by the pose stage; points {len(pts)}; BA cloud median distance to the true surface "
          f"{surf:.3f} m (not gated: the pose has no anchor)")
    # seed + constrained pass in the pose stage, the same two in stage 2
    if launches["best_target"] != 4 or "pose" not in stages:
        fail(f"the pose stage did not run its K3 passes: launches {launches}, stages {stages}")
    if launches["orientation_histograms"] == 0 or launches["descriptor_histograms"] == 0:
        fail("the command line did not launch K1 / K2")
    if not moved.any():
        fail("the pose stage left camera 1 as it was")
    if len(pts) == 0:
        fail("the --pose run kept no points")
    if not ba[1] <= ba[0]:
        fail("--pose run: BA final error exceeds the initial error")
    if not np.isfinite(pts).all():
        fail("non-finite points in the --pose BA cloud")
    return launches, {"matches": len(_ply(out, "ssrlcv-initial"))}


def phase_everest(dev):
    fixture = os.environ.get("SSRLCV_EVEREST_FIXTURE", "")
    if not os.path.isdir(fixture):
        print("[everest] skipped: the everest fixture pair is absent")
        return
    from scipy.spatial import cKDTree

    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig
    from ssrlcv_tpu_torch.io import refdata
    from ssrlcv_tpu_torch.core.types import FeatureSet
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.pipeline import stages as S

    fx = refdata.load_fixture_dir(fixture, 2)
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


DENSE_PLAIN_ROWS = 65536   # dense keypoints held against K2's plain version
DENSE_MIN_COMMON = 0.995   # fast and gather dense slot sets
# common dense rows whose descriptors may differ by more than K2_MAX_U8_DIFF:
# an angle one ulp apart moves a rotated sample lying on a .5 rounding tie
# to the next pixel (1-3 of 24,566 and 2 of 71,004 rows of the scene at
# 160^2 and 256^2 on the CPU, their angles 1-3 ulp apart)
DENSE_MAX_TIE_ROWS = 0.0005
STEREO_SHIFT = 24          # px the stereo target is rolled by
STEREO_MIN_SHARE = 0.9     # valid pixels that must find STEREO_SHIFT
PARALLEL_F = ((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0))


def _dense_slots(fs):
    """Slot keys (pixel * m + orientation rank) of a dense FeatureSet's rows,
    ascending, and the rows: a row's rank is its place among the rows of its
    pixel (pixel-major emission)."""
    from ssrlcv_tpu_torch.config import SIFTParams

    rows = torch.nonzero(fs.mask).squeeze(1)
    loc = fs.loc[rows].to(torch.int64)
    pix = loc[:, 1] * (1 << 20) + loc[:, 0]
    idx = torch.arange(pix.shape[0], device=pix.device)
    first = torch.ones_like(pix, dtype=torch.bool)
    first[1:] = pix[1:] != pix[:-1]
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    return pix * SIFTParams().max_orientations + (idx - start), rows


def _dense_parts(px, params, dev):
    """generate_dense_sift(fast=True)'s parts run in turn, with a CUDA event
    after each: (FeatureSet, seconds of field, compaction, descriptors)."""
    from ssrlcv_tpu_torch.features import dense as D
    from ssrlcv_tpu_torch.ops import image_ops as ops

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    gx, gy = ops.pixel_gradients(ops.normalize_minmax(ops.to_float(px)))
    theta_f, ok_f = D._dense_orientation_field(gx, gy, params, 5)
    ev[1].record()
    loc, theta = D._dense_compact(theta_f, ok_f, params, px.shape[1])
    ev[2].record()
    fs = D._dense_describe(gx, gy, loc, theta, 0, params, 6)
    ev[3].record()
    torch.cuda.synchronize()
    return fs, [ev[i].elapsed_time(ev[i + 1]) / 1e3 for i in range(3)], (gx, gy, loc, theta)


def phase_dense(scene, dev):
    """Phase 7: dense SIFT (fast path, then the gather oracle), Window_NxN
    features with SAD matching, dense stereo and FAST, on image 0 of the
    1024^2 scene on the card.  Returns ({kernel: launches}, the dense
    records of K1 and K2)."""
    from ssrlcv_tpu_torch.config import MatchParams, SIFTParams
    from ssrlcv_tpu_torch.features.dense import (_interior_grid, generate_dense_sift,
                                                 generate_window_features, sad_best_target)
    from ssrlcv_tpu_torch.features.desc_kernel import (descriptor_histograms,
                                                       descriptor_histograms_plain)
    from ssrlcv_tpu_torch.features.descriptor import descriptor_epilogue
    from ssrlcv_tpu_torch.features.fast import detect_fast
    from ssrlcv_tpu_torch.features.orient_kernel import (orientation_histograms,
                                                         orientation_histograms_plain)
    from ssrlcv_tpu_torch.geometry.stereo import generate_disparity_matches
    from ssrlcv_tpu_torch.matching.match import match_double_constrained
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.pipeline.stages import cameras_from_refimages

    t_phase = time.perf_counter()
    params = SIFTParams()
    img0 = scene.images[0].pixels
    px = torch.as_tensor(img0, device=dev)
    counters = (orientation_histograms, descriptor_histograms, best_target)
    launches = {fn.__name__: 0 for fn in counters}

    def run(fn):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        for c in counters:
            launches[c.__name__] += c.launches
        return out, time.perf_counter() - t0, {c.__name__: c.launches for c in counters}

    # 7a: the fast path, cold then warm, then its parts and K2 alone
    fs, cold, l7a = run(lambda: generate_dense_sift(img0, params, image_id=0, device=dev))
    n = fs.count()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    generate_dense_sift(img0, params, image_id=0, device=dev)
    ev[1].record()
    torch.cuda.synchronize()
    warm = ev[0].elapsed_time(ev[1]) / 1e3
    fs2, parts, (gx, gy, loc, theta) = _dense_parts(px, params, dev)
    if not (torch.equal(fs2.descriptors, fs.descriptors) and torch.equal(fs2.loc, fs.loc)):
        fail("dense SIFT: its parts run in turn differ from the entry point")
    sig = torch.ones_like(theta)
    lam_d = params.descriptor_contrib_width
    k2_args = (gx, gy, loc, theta, sig, 1.0, lam_d, 6)
    vk = descriptor_histograms(*k2_args)
    k2_ms = cuda_ms(lambda: descriptor_histograms(*k2_args), 5, "K2 dense")
    b2 = bound(_nbytes(gx, gy, loc, theta, sig, vk),
               _k2_samples(theta, sig, 1.0, lam_d, 6, chunk=65536) * K2_OPS_PER_SAMPLE,
               "fp32")
    m = min(DENSE_PLAIN_ROWS, n)
    sub = (gx, gy, loc[:m], theta[:m], sig[:m], 1.0, lam_d, 6)
    vp = descriptor_histograms_plain(*sub)
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    k2_err = _u8_diff(descriptor_epilogue(vk[:m], ones), descriptor_epilogue(vp, ones))
    k2_plain_ms = cuda_ms(lambda: descriptor_histograms_plain(*sub), 1, "K2 plain, dense")
    del vk, vp
    print(f"[dense] 7a fast path on {tuple(px.shape)}: {n} features (capacity {fs.capacity}); "
          f"first call {cold:.3f} s (host clock), warm {warm:.4f} s (CUDA events); parts: field "
          f"{parts[0]:.4f} s, compaction {parts[1]:.4f} s, descriptors (K2 + epilogue) "
          f"{parts[2]:.4f} s; launches {l7a}")
    print(f"[dense] K2 over {n} dense keypoints (window 6): {k2_ms:.4f} ms (device), bound "
          f"{b2['bound_ms']:.4f} ms ({b2['bound_by']}), {k2_ms / b2['bound_ms']:.1f}x; "
          f"{k2_ms / 1e3 / warm:.1%} of the warm call; vs plain on the first {m}: max |uint8 "
          f"diff| {k2_err} (gate {K2_MAX_U8_DIFF}), plain {k2_plain_ms:.3f} ms for those {m}")
    if l7a != {"orientation_histograms": 0, "descriptor_histograms": 1, "best_target": 0}:
        fail(f"dense SIFT's fast path did not launch K2 once alone: {l7a}")
    if k2_err > K2_MAX_U8_DIFF:
        fail("K2 disagrees with its plain version on dense keypoints")
    if n < 0.5 * (SIZE - 2 * params.border) ** 2:
        fail(f"dense SIFT: {n} features")
    k2_dense = {"keypoints": n, "ms": k2_ms, **b2, "plain_ms_first_rows": k2_plain_ms,
                "plain_rows": m, "max_abs_err": float(k2_err), "share_of_warm_call":
                k2_ms / 1e3 / warm}

    # 7b: the gather oracle, K1 over every interior pixel, then K2
    ref, t_gather, l7b = run(lambda: generate_dense_sift(img0, params, image_id=0, fast=False,
                                                         device=dev))
    ka, ra = _dense_slots(fs)
    kb, rb = _dense_slots(ref)
    pos = torch.clamp(torch.searchsorted(kb, ka), max=kb.shape[0] - 1)
    hit = kb[pos] == ka
    common = int(hit.sum())
    share = common / max(ka.shape[0], kb.shape[0])
    dd = (fs.descriptors[ra[hit]].int() - ref.descriptors[rb[pos[hit]]].int()).abs().amax(1)
    desc_diff, tie_rows = int(dd.max()), int((dd > K2_MAX_U8_DIFF).sum())
    dth = (fs.theta[ra[hit]] - ref.theta[rb[pos[hit]]]).abs()
    dth = float(torch.minimum(dth, 2 * np.pi - dth).max())
    # the gather path's keypoints: every interior pixel
    grid = _interior_grid(SIZE, SIZE, params.border, device=dev)
    gsig = torch.ones(grid.shape[0], device=dev)
    k1_args = (gx, gy, grid, gsig, 1.0, 5, params.orientation_contrib_width)
    hk = orientation_histograms(*k1_args)
    k1_ms = cuda_ms(lambda: orientation_histograms(*k1_args), 5, "K1 dense")
    b1 = bound(_nbytes(gx, gy, grid, gsig, hk),
               _k1_samples(gsig, 1.0, params.orientation_contrib_width, 5) * K1_OPS_PER_SAMPLE,
               "fp32")
    g = min(DENSE_PLAIN_ROWS, grid.shape[0])
    hp = orientation_histograms_plain(gx, gy, grid[:g], gsig[:g], *k1_args[4:])
    k1_err, k1_flip = _k1_gate(hk[:g], hp)
    k1_plain_ms = cuda_ms(lambda: orientation_histograms_plain(gx, gy, grid[:g], gsig[:g],
                                                               *k1_args[4:]), 1, "K1 plain, dense")
    print(f"[dense] 7b gather oracle: {ref.count()} features in {t_gather:.3f} s (host clock), "
          f"launches {l7b}; slots in common with 7a {common} ({share:.4%}, gate "
          f"{DENSE_MIN_COMMON:.1%}), max |angle diff| {dth:.3e} (gate 1e-3), max |uint8 diff| "
          f"{desc_diff}, rows beyond {K2_MAX_U8_DIFF}: {tie_rows} (gate "
          f"{DENSE_MAX_TIE_ROWS:.2%} of the common rows)")
    print(f"[dense] K1 over {grid.shape[0]} interior pixels (w_max 5): {k1_ms:.4f} ms (device), "
          f"bound {b1['bound_ms']:.4f} ms ({b1['bound_by']}), {k1_ms / b1['bound_ms']:.1f}x; vs "
          f"plain on the first {g}: max {k1_err:.3e}, outside rtol/atol {k1_flip} (gate "
          f"{K1_MAX_FLIP_FRACTION:.1%}), plain {k1_plain_ms:.3f} ms for those {g}")
    if l7b["orientation_histograms"] < 1 or l7b["descriptor_histograms"] < 1:
        fail(f"the dense gather path did not launch K1 and K2: {l7b}")
    if share < DENSE_MIN_COMMON or dth > 1e-3 or tie_rows > DENSE_MAX_TIE_ROWS * common:
        fail("dense SIFT's fast path disagrees with its gather oracle")
    if k1_flip > K1_MAX_FLIP_FRACTION * g:
        fail("K1 disagrees with its plain version on dense keypoints")
    k1_dense = {"keypoints": grid.shape[0], "ms": k1_ms, **b1, "plain_ms_first_rows": k1_plain_ms,
                "plain_rows": g, "max_abs_err": k1_err}
    del fs, fs2, ref, hk, hp, gx, gy, loc, theta, ka, kb, ra, rb, pos, hit

    # 7c: Window_NxN features, SAD best target, SAD epipolar matching
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf = generate_window_features(img0, window=9, device=dev)
    torch.cuda.synchronize()
    t_wf = time.perf_counter() - t0
    crop = img0[:64, :64]
    q = generate_window_features(crop, window=9, device=dev)
    t = generate_window_features(np.roll(crop, 5, axis=1), window=9, device=dev)
    idx, dist = sad_best_target(q.descriptors, t.descriptors, t.mask)
    qx, tx = q.loc[:, 0], t.loc[idx.long(), 0]
    inner = (qx > 8) & (qx < 50)
    dx5 = float((tx[inner] - qx[inner] == 5).float().mean())
    med = float(dist[inner].median())
    f1 = generate_window_features(scene.images[1].pixels, window=9, device=dev)
    qrows = torch.arange(0, wf.capacity, 2609, device=dev)[:400]
    trows = torch.arange(0, f1.capacity, 33, device=dev)
    sel = [(wf, qrows), (f1, trows)]
    qw, tw = (type(f)(loc=f.loc[r], descriptors=f.descriptors[r], mask=f.mask[r], window=9)
              for f, r in sel)
    mp = MatchParams(epsilon=25.0, delta=5.0)
    best_target.launches = 0
    dm = match_double_constrained(qw, tw, cameras_from_refimages(scene.images, dev), 0, 1, mp,
                                  metric="sad")
    k3_sad = best_target.launches
    cpu = lambda f: type(f)(loc=f.loc.cpu(), descriptors=f.descriptors.cpu(),  # noqa: E731
                            mask=f.mask.cpu(), window=9)
    dc = match_double_constrained(cpu(qw), cpu(tw), cameras_from_refimages(scene.images, "cpu"),
                                  0, 1, mp, metric="sad")
    agree = float((dm.target_idx.cpu() == dc.target_idx).float().mean())
    print(f"[dense] 7c window features (9x9) at {SIZE}^2: {wf.capacity} in {t_wf:.4f} s; SAD "
          f"best target on a 64^2 crop against it rolled 5 px: dx == 5 on {dx5:.2%} of the "
          f"inner rows (gate > 80 %), median distance {med} (gate 0); SAD epipolar matching "
          f"of {qw.capacity} x {tw.capacity} window features on the card: {int(dm.valid.sum())} "
          f"valid, K3 launches {k3_sad}, idx equal to the CPU run's on {agree:.2%}")
    if not (dx5 > 0.8 and med == 0.0):
        fail("SAD best target did not find the 5 px shift")
    if k3_sad != 0 or agree < 0.99 or not torch.isfinite(dm.distance).any():
        fail("SAD epipolar matching on the card disagrees with the CPU run")
    del wf, f1, qw, tw

    # 7d: dense stereo, the scanline search and the epipolar one
    shifted = np.roll(img0, STEREO_SHIFT, axis=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l0, l1 = generate_disparity_matches(img0, shifted, np.array(PARALLEL_F, np.float32),
                                        max_disparity=64, window=11, device=dev)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    # the pixels whose true target window lies inside the image (the others
    # have none in the search)
    inside = l0[:, 0] + STEREO_SHIFT + 5 < SIZE
    found = float(((l1[:, 0] - l0[:, 0])[inside] == STEREO_SHIFT).float().mean())
    F = np.array(PARALLEL_F, np.float32) + np.random.default_rng(SEED).normal(
        0, 1e-4, (3, 3)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0, e1 = generate_disparity_matches(img0, shifted, F, max_disparity=64, window=11, device=dev)
    torch.cuda.synchronize()
    t_epi = time.perf_counter() - t0
    print(f"[dense] 7d stereo at {SIZE}^2, 64 disparities, window 11: scanline {l0.shape[0]} "
          f"matches in {t_scan:.4f} s, disparity {STEREO_SHIFT} on {found:.2%} of those whose "
          f"target lies inside (gate "
          f"{STEREO_MIN_SHARE:.0%}); epipolar (non-pattern F) {e0.shape[0]} matches in "
          f"{t_epi:.4f} s (host clock)")
    if found < STEREO_MIN_SHARE:
        fail("the scanline stereo search did not find the shift")
    if e0.shape[0] == 0 or not torch.isfinite(e1).all():
        fail("the epipolar stereo search found nothing")

    # 7e: FAST on the card against the CPU
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = detect_fast(img0, device=dev)
    torch.cuda.synchronize()
    t_fast = time.perf_counter() - t0
    want = detect_fast(img0, device="cpu")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    print(f"[dense] 7e FAST: {int(got[2].sum())} corners in {t_fast:.4f} s (host clock), "
          f"identical to the CPU run: {same}")
    if not same or int(got[2].sum()) == 0:
        fail("FAST on the card differs from the CPU run")
    print(f"[dense] phase 7 {time.perf_counter() - t_phase:.1f} s; launches (7a + 7b) "
          f"{launches}")
    return launches, {"orientation_histograms": k1_dense, "descriptor_histograms": k2_dense}


def _synced(fn):
    """(fn(), seconds): host clock around ``fn`` between two synchronisations,
    the card's time for the step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _state_npz(ckpt, stage, cls, prefix, device):
    """The ``prefix`` dataclass of a stage checkpoint's state.npz on
    ``device``."""
    import dataclasses as dc

    with np.load(os.path.join(ckpt, f"sfm-stage{stage}", "state.npz")) as z:
        return cls.from_numpy(device=device, **{f.name: z[f"{prefix}.{f.name}"]
                                                for f in dc.fields(cls)})


def _pushbroom_point_tol(points, vec, pnt):
    """Per track, the bound ROADMAP.md caveat m gives: two ulps of the craft
    position and of each unit ray, carried over the range to the point and
    the angle between the two rays, 2 (ulp(|position|) + ulp(1) range) /
    sin(angle).  points (T, 3), vec and pnt (T, 2, 3), numpy."""
    ulp_pos = float(np.spacing(np.float32(np.abs(np.linalg.norm(pnt, axis=-1)).max())))
    rng_km = np.linalg.norm(points[:, None, :] - pnt, axis=-1).sum(1)
    sin_angle = np.linalg.norm(np.cross(vec[:, 0], vec[:, 1]), axis=-1)
    return 2.0 * (ulp_pos + float(np.spacing(np.float32(1.0))) * rng_km) / np.maximum(sin_angle,
                                                                                     1e-6)


def phase_pushbroom(scene, counters, dev):
    """Phase 8: the pair written as a directory whose params.csv holds
    pushbroom rows (synthetic.PUSHBROOM_CAMERA, rolls 88 and 92 deg), read
    by the loader, through seed SIFT + run_pipeline on the card with
    MatchParams(mode="brute") and stage checkpoints; then the CPU port's
    triangulation, filters and BA on the checkpointed stage-2 matches."""
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust
    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.core.types import MatchSet, PointCloud
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.geometry import filters as F
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.io.images import (cameras_from_refimages, load_directory,
                                            load_image_with_params, pushbrooms_from_refimages)
    from ssrlcv_tpu_torch.pipeline import stages as S
    from ssrlcv_tpu_torch.synthetic import write_pushbroom_scene_dir

    root = os.path.join("out", "chip_smoke_pushbroom")
    shutil.rmtree(root, ignore_errors=True)
    seed = write_pushbroom_scene_dir(scene, os.path.join(root, "images"))
    images = load_directory(os.path.join(root, "images"))
    ckpt = os.path.join(root, "ckpt")
    cfg = PipelineConfig(output_dir=os.path.join(root, "out"), checkpoint_dir=ckpt).replace(
        match=MatchParams(mode="brute", epsilon=25.0, delta=5.0), sift=SIFTParams())
    for fn in counters:
        fn.launches = 0
    seed_px = load_image_with_params(seed, -1, no_params=True).pixels

    def run():
        seed_fs = generate_features(seed_px, cfg.sift, image_id=-1, device=dev)
        return S.run_pipeline(S.PipelineState(config=cfg, images=images, seed_features=seed_fs,
                                              device=dev))

    st, e2e = _synced(run)
    launches = {fn.__name__: fn.launches for fn in counters}
    pb = st.pushbrooms
    print(f"[pushbroom] {[im.is_pushbroom for im in images]} pushbroom images, rolls "
          f"{pb.roll.tolist() if pb is not None else None} on "
          f"{pb.roll.device if pb is not None else None}; stages (s, CUDA events) "
          + ", ".join(f"{k} {v:.4f}" for k, v in st.stage_seconds.items())
          + f"; e2e {e2e:.3f} s (seed SIFT + pipeline); launches {launches}")
    if any(v == 0 for v in launches.values()) or launches["best_target"] < 2:
        fail("a kernel of the pushbroom path was not launched")
    if pb is None or pb.roll.device.type != "cuda":
        fail("state.pushbrooms is not on the card")

    # the CPU port on the card's stage-2 matches
    ms2 = _state_npz(ckpt, 2, MatchSet, "matches", "cpu")
    n_matches = ms2.count()
    pb_cpu = pushbrooms_from_refimages(images, "cpu")
    cams_cpu = cameras_from_refimages(images, "cpu")
    cpu3, _ = triangulate_matches(ms2, cams_cpu, True, pushbrooms=pb_cpu)
    jump = max(int(round(1.0 / cfg.filter.sample_fraction)), 1)
    ms4 = F.deterministic_statistical_filter(
        F.linear_cutoff_filter(ms2, cams_cpu, cfg.filter.linear_cutoff_km, pushbrooms=pb_cpu),
        cams_cpu, cfg.filter.statistical_sigma, jump, pushbrooms=pb_cpu)
    cpu4, _ = triangulate_matches(ms4, cams_cpu, True, pushbrooms=pb_cpu)
    worst = 0.0
    for stage, cpu, ms in ((3, cpu3, ms2), (4, cpu4, ms4)):
        card = _state_npz(ckpt, stage, PointCloud, "cloud", "cpu")
        m = card.mask.numpy()
        pts = card.points.numpy()[m]   # stage 4's is the filtered cloud
        print(f"[pushbroom] stage {stage}: {int(m.sum())} points on the card, "
              f"{int(cpu.mask.sum())} in the CPU port's run")
        if not np.isfinite(pts).all():
            fail(f"pushbroom stage-{stage} cloud: non-finite points where masked")
        if int(m.sum()) != int(cpu.mask.sum()) or not np.array_equal(m, cpu.mask.numpy()):
            fail(f"pushbroom stage-{stage} cloud: the card's points differ in count from the CPU's")
        bd = generate_bundles(ms, None, pushbrooms=pb_cpu)
        diff = np.linalg.norm(pts - cpu.points.numpy()[m], axis=1)
        tol = _pushbroom_point_tol(pts, bd.vec.numpy()[m], bd.pnt.numpy()[m])
        worst = max(worst, float((diff / tol).max()) if len(diff) else 0.0)
        print(f"[pushbroom] stage {stage}: max |card - CPU| {diff.max() if len(diff) else 0.0:.3e} "
              f"km against a caveat-m bound of {tol.min() if len(tol) else 0.0:.3e} to "
              f"{tol.max() if len(tol) else 0.0:.3e} km")
        if (diff > tol).any():
            fail(f"pushbroom stage-{stage} points differ from the CPU port's beyond caveat m")
    r = bundle_adjust(ms4, cams_cpu, cfg.ba)
    cpu_ba = (float(r.initial_error), float(r.final_error))
    nan_card, nan_cpu = np.isnan(st.ba_error), np.isnan(cpu_ba)
    print(f"[pushbroom] matches {n_matches}; BA on the card {st.ba_error}, on the CPU {cpu_ba} "
          f"(the zero pinhole cameras, ROADMAP.md caveat k)")
    if n_matches == 0:
        fail("the pushbroom path found no matches")
    if not np.array_equal(nan_card, nan_cpu):
        fail("pushbroom stage 5: NaN errors on the card and the CPU differ")
    surf = np.median(scene.surface_distance_m(pts)) if len(pts) else float("nan")
    print(f"[pushbroom] filtered cloud median distance to the scene's sphere {surf:.1f} m "
          f"(not gated: the pushbroom rows do not describe the renders' geometry, and the ray "
          f"keeps only the bits of caveat m)")
    return launches, {"e2e_s": e2e, "stage_s": dict(st.stage_seconds), "matches": n_matches,
                      "worst_diff_over_tol": worst}


MESH_RESOLUTION = 64       # reconstruct_surface's grid on the main path's cloud
# the CPU reference of reconstruct_surface runs at 32: at 64 it took 34.7 s
# on the H100 host's CPU, and the card's 64 is then gated on counts alone
MESH_CPU_RESOLUTION = 32
MESH_DEPTH = 6             # the octree-lattice meshers' depth
PLANAR_CUTOFF_KM = 0.05
# the pinhole rays' float32 sin / cos / tan and the 2-view triangulation's
# sums round differently on the card and the CPU (by an ulp), which moves a
# point of the main path's cloud, 400 km from its cameras, by well under a
# metre: the planar filter's distances may differ by that much, and a track
# whose distance straddles the cutoff between the two may be kept by one
PLANAR_DIST_TOL_KM = 1e-3


def _same_mesh(name, card, cpu, scale):
    """Counts exact, vertices within 1e-6 of the coordinates' scale."""
    if card.points.shape != cpu.points.shape or card.faces.shape != cpu.faces.shape:
        fail(f"{name}: the card's mesh ({card.points.shape[0]} vertices, {card.faces.shape[0]} "
             f"faces) differs from the CPU's ({cpu.points.shape[0]}, {cpu.faces.shape[0]})")
    err = float(np.abs(card.points - cpu.points).max()) if len(card.points) else 0.0
    if err > 1e-6 * scale or not np.array_equal(card.faces, cpu.faces):
        fail(f"{name}: vertices differ by {err:.3e} (scale {scale:.1f}) or faces differ")
    return err


def _planar_distances(ms, cams):
    """planar_cutoff_filter's point-to-plane distances and valid tracks."""
    from ssrlcv_tpu_torch.geometry import cloud_ops as ops
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.mesh import octree as oc

    pc, _ = triangulate_matches(ms, cams)
    valid = ms.mask & pc.mask
    tree = oc.build_octree(pc.points, valid)
    normal = ops.estimated_plane_normal(tree, oc.compute_normals(tree, cams.cam_pos, k=10))
    return torch.abs(oc._dot3(pc.points - ops.cloud_average(pc.points, valid), normal)), valid


def phase_mesh(st, dev):
    """Phase 9: on the main path's state (filtered matches, BA cloud and
    cameras on the card): the planar filter, the octree, normals and the
    low-density filter, the four meshers, the plane estimate, the debug
    clouds, each against the CPU port on the same inputs; then the
    reference features of tests/data through features_from_refdata and
    seed_distances (K3) against image 0's features."""
    from ssrlcv_tpu_torch.geometry import cloud_ops as ops
    from ssrlcv_tpu_torch.geometry import filters as F
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.io import ply
    from ssrlcv_tpu_torch.io.anatomy import read_features
    from ssrlcv_tpu_torch.features.sift import features_from_refdata
    from ssrlcv_tpu_torch.matching import match as M
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.mesh import meshfactory as MF
    from ssrlcv_tpu_torch.mesh import octree as oc

    def cpu(obj):
        return type(obj)(**{k: torch.as_tensor(v) for k, v in obj.to_numpy().items()})

    times = {}
    ms, cams, cloud = st.matches, st.cameras, st.cloud
    ms_c, cams_c, cloud_c = cpu(ms), cpu(cams), cpu(cloud)

    kept, times["planar_cutoff_filter"] = _synced(
        lambda: F.planar_cutoff_filter(ms, cams, PLANAR_CUTOFF_KM))
    kept_c = F.planar_cutoff_filter(ms_c, cams_c, PLANAR_CUTOFF_KM)
    d_card, valid = _planar_distances(ms, cams)
    d_cpu, _ = _planar_distances(ms_c, cams_c)
    d_card, valid = d_card.cpu(), valid.cpu()
    d_err = float((d_card - d_cpu).abs()[valid].max())
    flips = kept.mask.cpu() != kept_c.mask
    straddle = valid & (torch.minimum(d_card, d_cpu) <= PLANAR_CUTOFF_KM) & (
        torch.maximum(d_card, d_cpu) > PLANAR_CUTOFF_KM)
    print(f"[mesh] planar filter ({PLANAR_CUTOFF_KM} km): {kept.count()} of {ms.count()} tracks "
          f"kept on the card, {kept_c.count()} on the CPU; plane distances max |card - CPU| "
          f"{d_err:.3e} km (gate {PLANAR_DIST_TOL_KM}); {int(flips.sum())} tracks kept by one "
          f"only, all straddling the cutoff: {bool((~flips | straddle).all())}")
    if d_err > PLANAR_DIST_TOL_KM or not bool((~flips | straddle).all()):
        fail("planar_cutoff_filter: the card's mask differs from the CPU's beyond rounding")

    tree, times["build_octree"] = _synced(lambda: oc.build_octree(cloud.points, cloud.mask))
    tree_c = oc.build_octree(cloud_c.points, cloud_c.mask)
    normals, times["compute_normals"] = _synced(lambda: oc.compute_normals(tree, cams.cam_pos))
    normals_c = oc.compute_normals(tree_c, cams_c.cam_pos)
    dense, times["remove_low_density_points"] = _synced(lambda: oc.remove_low_density_points(tree))
    dense_c = oc.remove_low_density_points(tree_c)
    m = tree_c.mask
    nerr = float((normals.cpu()[m] - normals_c[m]).abs().max())
    print(f"[mesh] octree over {int(m.sum())} points: keys, order and mask equal to the CPU's: "
          f"{all(torch.equal(a.cpu(), b) for a, b in zip(tree[:4], tree_c[:4]))}; normals max "
          f"|card - CPU| {nerr:.3e} (gate 1e-6); low-density filter keeps {int(dense.mask.sum())}")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(tree[:4], tree_c[:4])):
        fail("build_octree: the card's tree differs from the CPU's")
    if not nerr <= 1e-6 or not torch.equal(dense.mask.cpu(), dense_c.mask):
        fail("compute_normals / remove_low_density_points differ from the CPU's")

    pts = cloud.points[cloud.mask].contiguous()
    ones = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    scale = float(pts.abs().max())
    meshers = [("reconstruct_surface", lambda p, o, c, r: MF.reconstruct_surface(
                   p, o, c, resolution=r), MESH_RESOLUTION, MESH_CPU_RESOLUTION)]
    meshers += [(name, lambda p, o, c, r, f=getattr(MF, name): f(p, o, c, depth=r), MESH_DEPTH,
                 MESH_DEPTH)
                for name in ("marching_cubes_octree", "adaptive_marching_cubes", "jax_meshing")]
    meshes = {}
    for name, run, full, size in meshers:
        card, times[name] = _synced(lambda: run(pts, ones, cams.cam_pos, full))
        if not (len(card.faces) > 0 and np.isfinite(card.points).all()):
            fail(f"{name}: no faces or non-finite vertices on the card")
        held = card if size == full else run(pts, ones, cams.cam_pos, size)
        ref, cpu_s = _synced(lambda: run(pts.cpu(), ones.cpu(), cams_c.cam_pos, size))
        err = _same_mesh(name, held, ref, scale)
        meshes[name] = card
        print(f"[mesh] {name} ({'resolution' if name == 'reconstruct_surface' else 'depth'} "
              f"{full}): {len(card.points)} vertices, {len(card.faces)} faces, {times[name]:.4f} s "
              f"on the card; at {size} the card's mesh ({len(held.faces)} faces) equals the "
              f"CPU's ({cpu_s:.2f} s): counts equal, vertices within {err:.3e}")

    out = os.path.join("out", "chip_smoke_mesh")
    shutil.rmtree(out, ignore_errors=True)
    plane, times["visualize_plane_estimation"] = _synced(
        lambda: ops.visualize_plane_estimation(cloud, cams, os.path.join(out, "plane.ply")))
    bd = generate_bundles(ms, cams)
    written = {
        "plane": (plane, 50 * 50),
        "debug": (ops.save_debug_cloud(os.path.join(out, "debug"), cloud, cams, bd),
                  int(cloud.mask.sum()) + cams.num_cameras + 2 * ms.count()),
        "linear_error": (ops.save_linear_error_cloud(os.path.join(out, "error"), cloud),
                         int(cloud.mask.sum())),
        "view_number": (ops.save_view_number_cloud(os.path.join(out, "views"), cloud, ms),
                        int(cloud.mask.sum())),
        "mesh": (MF.generate_mesh(meshes["jax_meshing"], out, "main", MESH_DEPTH),
                 len(meshes["jax_meshing"].points)),
    }
    for name, (path, n) in written.items():
        back = ply.read_ply(path)
        if len(back["points"]) != n or not np.isfinite(back["points"]).all():
            fail(f"{name}: {path} read back {len(back['points'])} points, not {n}")
        if name != "mesh" and name != "plane" and back["colors"] is None:
            fail(f"{name}: {path} has no colours")
    print(f"[mesh] written and read back: {', '.join(written)}")

    ref = read_features(os.path.join("tests", "data", "anatomy_seed_features.txt"))
    best_target.launches = 0
    (ref_fs, dist), times["features_from_refdata + seed_distances"] = _synced(
        lambda: (lambda fs: (fs, M.seed_distances(st.features[0], fs)))(
            features_from_refdata(ref, device=dev)))
    k3 = best_target.launches
    want = M.seed_distances(cpu(st.features[0]), cpu(ref_fs))
    same = torch.equal(dist.cpu(), want)
    print(f"[mesh] reference features: {ref_fs.count()} (capacity {ref_fs.capacity}) against "
          f"image 0's {st.features[0].count()}: K3 launched {k3}, distances bit-identical to the "
          f"plain version: {same}")
    if k3 == 0 or not same:
        fail("seed_distances on the reference features: K3 not launched or not the plain result")
    print("[mesh] card seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return {"best_target": k3}, times


# BA final error over a mesh against its reference (tests/test_sharded.py):
# for 10a phase 3's single-device BA; for 10b the plain reference that sums
# the same two track blocks (_blocked_lm), because the single-device LM on
# these tracks lands ~1 % apart when only the order the tracks are summed in
# changes (the reversed-order run printed in 10b; PERF.md §6).  10b is also
# held to phase 3's BA within that order spread, MESH_BA_ORDER_RTOL.
MESH_BA_RTOL = 1e-3
MESH_BA_ORDER_RTOL = 2e-2


def _blocked_lm(matches, cams, blocks: int, iterations: int = 10):
    """The plain reference of BA over ``blocks`` data ranks, in one
    process: the LM loop of ba.lm as 2-view BA runs it (camera 0 pinned)
    with the error, gradient and Hessian each the sum, in rank order, of
    the torch.func values over the tracks' equal blocks (padded with masked
    tracks).  Returns the (initial, final) error."""
    from torch.func import grad, hessian

    from ssrlcv_tpu_torch.ba.lm import pack
    from ssrlcv_tpu_torch.ba.two_view import make_objective
    from ssrlcv_tpu_torch.core.types import MatchSet

    n = -(-matches.capacity // blocks)
    pad = n * blocks - matches.capacity
    fields = {k: torch.cat([v, torch.full((pad,) + tuple(v.shape[1:]), -1 if k == "kp_parent" else 0,
                                          dtype=v.dtype, device=v.device)])
              for k, v in vars(matches).items()}
    objs = [make_objective(MatchSet(**{k: v[i * n:(i + 1) * n] for k, v in fields.items()}), cams)
            for i in range(blocks)]

    def total(fn, p):
        out = fn(objs[0])(p)
        for o in objs[1:]:
            out = out + fn(o)(p)
        return out

    p = pack(cams)
    free = torch.ones_like(p)
    free[:6] = 0.0
    init = best_err = total(lambda o: o, p)
    lam = torch.tensor(1e-3, dtype=p.dtype, device=p.device)  # a float32 lambda, as the LM's
    for i in range(iterations):
        H, g = total(hessian, p), total(grad, p) * free
        damped = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
        damped = damped * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        new = p - torch.linalg.solve_ex(damped, g)[0] * free
        err = total(lambda o: o, new)
        if bool(err < best_err):
            p, best_err, lam = new, err, lam * 0.3
        elif i > 0:
            break
        else:
            lam *= 10.0
    return float(init), float(best_err)


def _mesh_run(mesh, out_dir, device):
    """Seed SIFT + run_pipeline over ``mesh`` on the main path's pair (the
    config of phase 3), counters reset just before.  Returns (state,
    launches, host seconds)."""
    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.pipeline import stages as S
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(SEED, SIZE)
    cfg = PipelineConfig(output_dir=out_dir).replace(
        match=MatchParams(epsilon=25.0, delta=5.0), sift=SIFTParams())
    counters = (orientation_histograms, descriptor_histograms, best_target)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seed_fs = generate_features(scene.seed_image.pixels, cfg.sift, image_id=-1, device=device)
    st = S.run_pipeline(S.PipelineState(config=cfg, images=scene.images, seed_features=seed_fs,
                                        device=device, mesh=mesh))
    torch.cuda.synchronize()
    return st, {fn.__name__: fn.launches for fn in counters}, time.perf_counter() - t0


def _ba_gate(tag, ba, ref_ba, rtol=MESH_BA_RTOL):
    """BA's final error not above its initial one and within ``rtol`` of
    ``ref_ba``'s; a list of failures."""
    if ba[1] <= ba[0] and abs(ba[1] - ref_ba[1]) <= rtol * abs(ref_ba[1]):
        return []
    return [f"{tag}: BA {tuple(ba)} against {tuple(float(x) for x in ref_ba)} (rtol {rtol})"]


def _mesh_gates(tag, st, launches, ref):
    """The mesh run's gates against phase 3's state ``ref`` (a dict of numpy
    arrays): every main-path kernel launched, the filtered matches equal,
    the initial cloud (one point per match) equal.  Returns a list of
    failures."""
    from ssrlcv_tpu_torch.io import ply

    bad = []
    if any(v == 0 for v in launches.values()):
        bad.append(f"{tag}: a kernel of the main path was not launched ({launches})")
    m = st.matches.to_numpy()
    if not (np.array_equal(m["mask"], ref["mask"]) and np.array_equal(m["kp_loc"], ref["kp_loc"])):
        bad.append(f"{tag}: the filtered matches differ from phase 3's")
    initial = ply.read_ply(os.path.join(st.config.output_dir, "ssrlcv-initial.ply"))["points"]
    if not np.array_equal(initial, ref["initial"]):
        bad.append(f"{tag}: the initial cloud differs from phase 3's")
    return bad


def _mesh_rank(rank, world, port, ref_path, out_root, device, results):
    """One rank of phase 10b (a spawned process): a gloo group of ``world``
    ranks on ``device``, a (world x 1) mesh, the main path over it."""
    from ssrlcv_tpu_torch.parallel import mesh as pm

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        pm.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
        try:
            mesh = pm.make_mesh(world, 1, device_type="cpu")
            st, launches, seconds = _mesh_run(mesh, os.path.join(out_root, f"p{rank}"), device)
            ref = dict(np.load(ref_path))
            results.put((rank, launches, seconds, dict(st.stage_seconds), st.ba_error,
                         _mesh_gates(f"10b rank {rank}", st, launches, ref)))
        finally:
            torch.distributed.destroy_process_group()
    except Exception as e:  # reported to the parent, which fails the run
        results.put((rank, {}, 0.0, {}, None, [f"10b rank {rank}: {type(e).__name__}: {e}"]))
        raise


def phase_multi_device(st3, dev):
    """10a: one process, NCCL, a 1 x 1 mesh; 10b: 2 gloo ranks spawned on
    cuda:0, a 2 x 1 mesh.  Each runs the main path's pair through
    run_pipeline(mesh=...) at full width and is held to phase 3's state
    ``st3``.  One card gives no evidence of NCCL scale-out (NCCL refuses two
    ranks on one card): 10b shows the sharded stages' collectives and
    gathers across processes, not their speed."""
    import multiprocessing as mp
    import socket

    from ssrlcv_tpu_torch.io import ply
    from ssrlcv_tpu_torch.parallel import mesh as pm

    m3 = st3.matches.to_numpy()
    ref = {"mask": m3["mask"], "kp_loc": m3["kp_loc"], "ba": np.array(st3.ba_error),
           "initial": ply.read_ply(os.path.join(st3.config.output_dir,
                                                "ssrlcv-initial.ply"))["points"]}
    root = os.path.join("out", "chip_smoke_multi")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ref_path = os.path.join(root, "phase3.npz")
    np.savez(ref_path, **ref)

    if not pm.initialize_single("nccl"):
        fail("10a: a process group existed before phase 10")
    try:
        mesh = pm.make_mesh(1, 1, device_type="cuda")
        st, launches10a, seconds = _mesh_run(mesh, os.path.join(root, "single"), dev)
    finally:
        torch.distributed.destroy_process_group()
    print(f"[multi] 10a NCCL 1 x 1: stages (s, CUDA events) "
          + ", ".join(f"{k} {v:.4f}" for k, v in st.stage_seconds.items())
          + f"; seed SIFT + pipeline {seconds:.3f} s; matches {st.matches.count()}; "
          f"BA {st.ba_error[0]!r} -> {st.ba_error[1]!r}; launches {launches10a}")
    bad = _mesh_gates("10a", st, launches10a, ref) + _ba_gate("10a", st.ba_error, st3.ba_error)
    if bad:
        fail("; ".join(bad))

    world = 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, world, port, ref_path, root, str(dev), results))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, *rest = results.get(timeout=300)
            got[rank] = rest
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    # the plain reference of the 2-rank sums, and the single-device LM on the
    # same tracks summed in another order (reversed), printed for the spread
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.pipeline import stages as S

    cams = S.cameras_from_refimages(st3.images, dev)
    blocked = _blocked_lm(st3.matches, cams, world)
    rev = torch.flip(torch.arange(st3.matches.capacity, device=dev), [0])
    r = bundle_adjust(MatchSet(**{k: v[rev] for k, v in vars(st3.matches).items()}), cams,
                      st3.config.ba)
    print(f"[multi] 10b BA references: {world} blocks summed in rank order "
          f"{blocked[0]!r} -> {blocked[1]!r}; phase 3 {st3.ba_error[1]!r}; the same tracks "
          f"reversed on one device {float(r.final_error)!r}")
    launches10b = {}
    bad = []
    for rank in range(world):
        launches, seconds, stages, ba, fails = got.get(rank, ({}, 0.0, {}, None, ["no result"]))
        if ba:
            bad += _ba_gate(f"10b rank {rank}", ba, blocked)
            bad += _ba_gate(f"10b rank {rank} vs phase 3", ba, st3.ba_error, MESH_BA_ORDER_RTOL)
        bad += fails
        for k, v in launches.items():
            launches10b[k] = launches10b.get(k, 0) + v
        print(f"[multi] 10b gloo 2 x 1, rank {rank} on cuda:0: stages (s, CUDA events) "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f"; seed SIFT + pipeline {seconds:.3f} s; BA {ba}; launches {launches}")
    print(f"[multi] 10b: {world} processes in {wall:.1f} s (start-up included)")
    if bad or any(p.exitcode != 0 for p in procs):
        fail("; ".join(bad) or "a 10b rank exited non-zero")
    return launches10a, launches10b

# each driver of phase 11: (module, argv, the kernels it must launch)
BENCH_DRIVERS = (
    ("bench.reconstruct", ["--reps", "1"],
     ("orientation_histograms", "descriptor_histograms", "best_target")),
    ("bench.profile_sift", [], ("orientation_histograms", "descriptor_histograms")),
    ("tester", ["--out", os.path.join("out", "chip_smoke_tester")], ("best_target",)),
    ("bench.match_kernel", [], ("best_target",)),
    ("bench.nview", [], ("orientation_histograms", "descriptor_histograms", "best_target")),
    ("bench.pose", [], ("orientation_histograms", "descriptor_histograms", "best_target")),
    ("bench.dense", [], ("descriptor_histograms",)),
    ("bench.scaling", [], ("best_target",)),
)


def _run_driver(module, argv, scene3):
    """``main(argv)`` of ``ssrlcv_tpu_torch.<module>`` in this process on
    the synthetic scene at SIZE^2 (seed SEED): ``scene3`` where it is not
    None, else rendered by the driver; its standard output captured;
    returns (its record, seconds).  Fails unless the last line it printed
    is that record, as JSON."""
    import contextlib
    import importlib
    import inspect
    import io

    mod = importlib.import_module(f"ssrlcv_tpu_torch.{module}")
    if "synthetic" in inspect.signature(mod.main).parameters:
        argv = argv + ["--size", str(SIZE), "--seed", str(SEED)]
        kw = {"synthetic": scene3} if scene3 is not None else {}
    else:
        kw = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rec = mod.main(argv, **kw)
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"{module}: its last line is not a JSON record")
    if last != json.loads(json.dumps(rec)):
        fail(f"{module}: the record printed differs from the one returned")
    return rec, seconds, lines


def phase_bench(scene3, card, main_state, cli3, cli_pose, dense_features):
    """Phase 11: every measurement driver's main on the card, on the
    synthetic scene at SIZE^2 (seed SEED), each record printed on a
    [bench] line; gated on its own checks and against phases 3, 7a.
    Returns the launches the drivers counted, summed by kernel."""
    launches = {}
    recs = {}
    t_phase = time.perf_counter()
    for module, argv, kernels in BENCH_DRIVERS:
        # the tester renders its scene, as a user's run does: its log's
        # heartbeat (every second) beats while it renders
        rec, seconds, lines = _run_driver(module, argv, None if module == "tester" else scene3)
        name = module.split(".")[-1]
        recs[name] = rec
        print(f"[bench] {name} ({seconds:.1f} s): {json.dumps(rec)}")
        if name == "tester":
            print(f"[bench] tester printed: {lines[-2]}")
        dev = rec.get("device", {})
        if dev.get("name") != card or not dev.get("power_limit_w", 0) > 0:
            fail(f"{name}: the record does not name the card {card!r}: {dev}")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if not all(rec["launches"].get(k, 0) > 0 for k in kernels):
            fail(f"{name}: a kernel of its path was not launched: {rec['launches']}")

    r = recs["reconstruct"]
    n3, ba3 = main_state.matches.count(), main_state.ba_error
    print(f"[bench] reconstruct: {r['points']} points, BA {r['ba_initial_error']!r} -> "
          f"{r['ba_final_error']!r}, cloud {r['cloud_vs_surface_m']:.3f} m from the true surface;"
          f" phase 3: {n3} points, BA {ba3[0]!r} -> {ba3[1]!r}")
    if not (r["points"] > MIN_POINTS and r["ba_final_error"] <= r["ba_initial_error"]):
        fail("reconstruct: bench.py's gates (points > 1000, BA not up)")
    if not r["cloud_vs_surface_m"] <= MAX_SURFACE_MEDIAN_M:
        fail("reconstruct: the cloud is too far from the true surface")
    if r["points"] != n3 or r["ba_final_error"] != ba3[1]:
        fail("reconstruct: points or BA final error differ from phase 3's (the same steps)")
    p = recs["profile_sift"]
    print(f"[bench] profile_sift: parts {p['sum_of_parts_s']:.4f} s of the marked call's "
          f"{p['pass_s']:.4f} s; generate_features e2e {p['value']:.4f} s (image 0)")
    if not p["sum_of_parts_s"] <= p["value"] * (1.0 + PROFILE_RTOL):
        fail("profile_sift: the sum of its parts exceeds the e2e SIFT time")
    if not abs(p["pass_s"] - p["value"]) <= PROFILE_RTOL * p["value"]:
        fail("profile_sift: the marked call's time is not generate_features' e2e time")
    t = recs["tester"]
    with open(t["log"]) as f:
        rows = [line.rstrip("\n").split(",", 2)[1:] for line in f]
    beats = rows.count(["comment", "heartbeat"])
    print(f"[bench] tester: {len(rows)} log rows, {beats} heartbeats")
    if ["state", "start"] not in rows or ["state", "end"] not in rows or beats < 1:
        fail("tester: its log lacks the start / end rows or a heartbeat")
    nv, po = recs["nview"], recs["pose"]
    print(f"[bench] nview: {nv['tracks']} tracks -> {nv['filtered_tracks']} filtered, BA "
          f"{nv['ba_initial_error']!r} -> {nv['ba_final_error']!r}; phase 5 (command line): "
          f"{cli3['tracks']} -> {cli3['filtered_tracks']}")
    print(f"[bench] pose: {po['pose_matches']} pose matches, {po['post_pose_matches']} "
          f"post-pose matches; phase 6 (command line, --pose): {cli_pose['matches']}")
    if po["pose_matches"] == 0:
        print("[bench] pose: no pair of this scene passes the pose thresholds, so the pose "
              "driver measures no LM here (value null)")
    if (po["value"] is None) != (po["pose_matches"] == 0):
        fail("pose: the record times an LM with no match, or times nothing with matches")
    d = recs["dense"]
    print(f"[bench] dense: {d['features']} features, warm {d['value']:.4f} s; phase 7a: "
          f"{dense_features}")
    if d["features"] != dense_features:
        fail("dense: the feature count differs from phase 7a's")
    print(f"[bench] phase 11 {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


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
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    t0 = time.perf_counter()
    scene3 = make_scene(SEED, SIZE, n_views=3)
    # images 0 and 1 and the seed image of the 3-view scene are the 2-view
    # scene's
    scene = dataclasses.replace(scene3, images=scene3.images[:2])
    print(f"[scene] synthetic 3 views + seed image at {SIZE}^2 (seed {SEED}) in "
          f"{time.perf_counter() - t0:.2f} s")

    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.detect_kernel import detect_keypoints
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.ops.image_ops import convolve_separable_symmetric

    counters = (orientation_histograms, descriptor_histograms, best_target,
                convolve_separable_symmetric, detect_keypoints)
    recs = {**phase_kernels_features(scene, dev), **phase_kernels_blur(scene, dev),
            **phase_kernels_detect(scene, dev), **phase_kernels_match(scene, dev),
            **phase_gather(dev)}
    by_phase = {}
    by_phase["3"], main_state = phase_main_path(scene, dev)
    by_phase["3b"], k4_brute = phase_brute(scene, dev)
    recs["best_target_mma"].update(
        phase="2 + 3b: best_target_mma on the main path's and the brute path's features",
        launches=recs["best_target_mma"]["launches"] + k4_brute)
    phase_ba_modes(main_state, scene, dev)
    phase_everest(dev)
    by_phase["5"], cli3 = phase_cli_nview(scene3, counters)
    by_phase["6"], cli_pose = phase_cli_pose(scene, counters)
    by_phase["7"], dense = phase_dense(scene, dev)
    for name, rec in dense.items():
        recs[name]["dense"] = rec
    by_phase["8"], _ = phase_pushbroom(scene, counters, dev)
    by_phase["9"], _ = phase_mesh(main_state, dev)
    by_phase["10a"], by_phase["10b"] = phase_multi_device(main_state, dev)
    by_phase["11"] = phase_bench(scene3, card, main_state, cli3, cli_pose,
                                 dense["descriptor_histograms"]["keypoints"])
    for fn in counters:
        name = fn.__name__
        recs[name].update(phase="3, 3b, 5, 6, 7, 8, 9, 10a, 10b, 11: main path, brute path, "
                                "command line (3 views; 2 views with --pose), dense SIFT and "
                                "stereo, pushbroom cameras, mesh and reference features, the main "
                                "path over a 1 x 1 NCCL mesh and over 2 gloo ranks, the "
                                "measurement drivers",
                          launches=sum(p.get(name, 0) for p in by_phase.values()),
                          launches_by_phase={k: p[name] for k, p in by_phase.items()
                                             if name in p})
    print(f"[time] chip_smoke {time.perf_counter() - t_start:.1f} s after start")

    if any(m.split(".")[0] in ("jax", "ssrlcv_tpu") for m in sys.modules):
        fail("jax or the JAX package was imported")
    sources = {
        "orientation_histograms": ("csrc/orient.cu", "ssrlcv_tpu/features/orient_kernel.py:57"),
        "descriptor_histograms": ("csrc/desc.cu", "ssrlcv_tpu/features/desc_kernel.py:77"),
        "best_target": ("csrc/match.cu", "ssrlcv_tpu/matching/pallas_match.py:129"),
        "best_target_mma": ("csrc/match_mma.cu", "ssrlcv_tpu/matching/pallas_match.py:39"),
        "extract_patches": ("csrc/patches.cu", "ssrlcv_tpu/features/patches.py:47"),
        "patch_row_sums": ("csrc/gather.cu", "scripts/bench_gather2.py:139"),
        "convolve_separable_symmetric": (
            "csrc/blur.cu", "none: ssrlcv_tpu/ops/image_ops.py:136 leaves the blur to XLA"),
        "detect_keypoints": (
            "csrc/detect.cu", "none: ssrlcv_tpu/features/detector.py is XLA operations"),
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
