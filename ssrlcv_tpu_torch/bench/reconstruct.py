"""End-to-end 2-view reconstruction benchmark on one CUDA device.

    python -m ssrlcv_tpu_torch.bench.reconstruct [--fixture DIR] [--size N] [--seed S] [--reps R]

Counterpart of ``bench.py``: SIFT of both images -> seed distances ->
double-constrained matching (epsilon 25 px, delta 5 km) -> the match set ->
linear cutoff (100) and statistical filter (3 sigma, every 10th) -> BA (LM,
10 iterations), run once to warm up, then ``--reps`` times; the headline is
the least of those host times, each to a final ``synchronize``.  Two more
runs synchronise after every stage for its seconds (the first pays the
extra synchronisations' one-time costs), then ``extra_metrics``.  Prints one
JSON record as the last line, with bench.py's fields (but ``vs_baseline``,
a budget rather than a measurement) plus the list of runs, the device and
the scene.

The scene is the synthetic one (``bench.scene``) unless ``--fixture`` names
the reference's ``test/checkpoints/Pipeline2View`` layout; the distance of
the filtered cloud to the truth is then ``cloud_vs_golden_m`` (to the
golden ``points0``), else ``cloud_vs_surface_m``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ssrlcv_tpu_torch.bench import scene as S
from ssrlcv_tpu_torch.config import MatchParams, SIFTParams

MIN_POINTS = 1000            # bench.py's reconstruction-collapse bound


def run_once(images, cams, seed, sift_params: SIFTParams = SIFTParams(), stage_s=None,
             min_points: int = MIN_POINTS):
    """``bench.py::run_once`` on the device of ``cams``: returns (points
    after filtering, BA final error, (f0, f1, seed distances, match
    params, filtered MatchSet, BA result)).  With ``stage_s`` the device is
    synchronised after each stage and its host seconds added there under
    sift_both, match, filter and ba.  Raises when ``min_points`` or fewer
    points survive."""
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust_two_view
    from ssrlcv_tpu_torch.features.sift import generate_features_many
    from ssrlcv_tpu_torch.geometry import filters as F
    from ssrlcv_tpu_torch.matching import match as M

    dev = cams.cam_pos.device

    def tick(name, t0):
        if stage_s is not None:
            S.sync(dev)
            stage_s[name] = stage_s.get(name, 0.0) + (time.perf_counter() - t0)
        return time.perf_counter()

    t = time.perf_counter()
    f0, f1 = generate_features_many([images[0].pixels, images[1].pixels], sift_params,
                                    image_ids=[0, 1], device=dev)
    t = tick("sift_both", t)
    sd = M.seed_distances(f0, seed)
    params = MatchParams(epsilon=25.0, delta=5.0)
    dm = M.match_double_constrained(f0, f1, cams, 0, 1, params, seed_dist=sd)
    ms = M.matches_to_matchset(dm, f0, f1, 0, 1)
    t = tick("match", t)
    ms = F.linear_cutoff_filter(ms, cams, 100.0)
    ms = F.deterministic_statistical_filter(ms, cams, 3.0, 10)
    t = tick("filter", t)
    r = bundle_adjust_two_view(ms, cams, iterations=10, mode="lm")
    n = ms.count()
    tick("ba", t)
    if n <= min_points:
        raise RuntimeError(f"reconstruction collapsed: {n} points")
    return n, float(r.final_error), (f0, f1, sd, params, ms, r)


def extra_metrics(sc, arts, sift_params: SIFTParams = SIFTParams()) -> dict:
    """Warm per-stage seconds (least of three, host clock to a
    ``synchronize``), the match kernel's utilisation, and the filtered
    cloud's distance to the truth.

    Utilisation: the operations are the 2 * 128 int8 operations of every
    (live query, live target) pair of the ungated pass of image 0's
    features against image 1's (p1 = p2 = +inf, epsilon 0: every pair is
    needed there), over the H100's 1,979 TOP/s int8 peak.  ``mfu_match``
    times K3 with its preparation on the host clock to a ``synchronize``;
    ``mfu_match_kernel`` times K3 alone on a prepared layout with CUDA
    events.  bench.py counts 4 nibble matmuls over the padded capacities
    against a TPU's bf16 peak instead; the two are not comparable."""
    from ssrlcv_tpu_torch.bench.profile_sift import detect_all
    from ssrlcv_tpu_torch.bench.timing import cuda_ms
    from ssrlcv_tpu_torch.features.sift import generate_features, generate_features_many
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.matching import match as M
    from ssrlcv_tpu_torch.matching.match_kernel import best_target, launch, prepare

    f0, f1, sd, params, ms, _ = arts
    cams, dev = sc.cameras, sc.cameras.cam_pos.device
    px0, px1 = sc.images[0].pixels, sc.images[1].pixels

    def least(fn, reps=3):
        return S.min_seconds(fn, dev, reps)[1]

    st = {"sift_per_image": least(lambda: generate_features(px0, sift_params, 0, device=dev)),
          "sift_batch2_per_image": least(lambda: generate_features_many(
              [px0, px1], sift_params, image_ids=[0, 1], device=dev)) / 2.0,
          "sift_detect": least(lambda: detect_all(torch.as_tensor(px0, device=dev),
                                                  sift_params))}
    st["sift_describe"] = max(st["sift_per_image"] - st["sift_detect"], 0.0)
    st["match"] = least(lambda: M.match_double_constrained(f0, f1, cams, 0, 1, params,
                                                           seed_dist=sd))
    pc, _ = triangulate_matches(ms, cams)
    st["triangulate"] = least(lambda: triangulate_matches(ms, cams))

    inf2 = torch.full((f0.capacity, 2), torch.inf, dtype=torch.float32, device=dev)
    args = (f0.descriptors, f1.descriptors, f1.loc.contiguous(), inf2, inf2, 0.0, f1.mask, f0.mask)
    t_match = least(lambda: best_target(*args), reps=6)
    prep = prepare(*args)
    kernel_ms, queued = cuda_ms(lambda: launch(prep), 6)
    ops = 2 * 128 * f0.count() * f1.count()
    d = sc.distance_m(pc.points[ms.mask])
    return {"stages_device_s": st, "match_ops": ops, "peak_ops_per_s": S.H100_INT8_PER_S,
            "match_s": t_match, "match_kernel_ms": kernel_ms, "match_kernel_queued": queued,
            "mfu_match": ops / t_match / S.H100_INT8_PER_S,
            "mfu_match_kernel": ops / (kernel_ms / 1e3) / S.H100_INT8_PER_S,
            f"cloud_vs_{sc.truth}_m": float(np.median(d)) if len(d) else None}


def main(argv=None, synthetic=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.bench.reconstruct",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", help="a Pipeline2View fixture directory")
    ap.add_argument("--size", type=int, default=1024, help="synthetic scene size")
    ap.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    ap.add_argument("--reps", type=int, default=3, help="timed runs after the warm-up")
    args = ap.parse_args(argv)
    dev = S.require_cuda(ap.prog)
    sc = S.load(args.fixture, args.size, args.seed, 2, dev, synthetic=synthetic)
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.matching.match_kernel import best_target

    counters = (orientation_histograms, descriptor_histograms, best_target)
    for fn in counters:
        fn.launches = 0
    run_once(sc.images, sc.cameras, sc.seed)  # warm-up
    runs = []
    for _ in range(args.reps):
        S.sync(dev)
        t0 = time.perf_counter()
        n_points, final_err, arts = run_once(sc.images, sc.cameras, sc.seed)
        S.sync(dev)
        runs.append(time.perf_counter() - t0)
    # the kernels' launches in the warm-up and the timed runs
    launches = {fn.__name__: fn.launches for fn in counters}
    run_once(sc.images, sc.cameras, sc.seed, stage_s={})
    stage_s = {}
    n_points, final_err, arts = run_once(sc.images, sc.cameras, sc.seed, stage_s=stage_s)
    extra = extra_metrics(sc, arts)
    elapsed = min(runs)
    fps = 2.0 / elapsed
    out = {"metric": "reconstruction_fps", "value": fps, "unit": "frames/s",
           "e2e_seconds": elapsed, "e2e_seconds_runs": runs, "reps": args.reps,
           "points": n_points, "ba_initial_error": float(arts[5].initial_error),
           "ba_final_error": final_err, "ba_error_per_point": final_err / max(n_points, 1),
           **{k: extra[k] for k in (f"cloud_vs_{sc.truth}_m", "mfu_match", "mfu_match_kernel",
                                    "match_ops", "peak_ops_per_s", "match_s", "match_kernel_ms",
                                    "match_kernel_queued")},
           "mfu_base": "2*128 int8 ops per live (query, target) pair of the ungated pass of "
                       "image 0 against image 1, over 1979e12 op/s (H100 int8 peak)",
           "stages": stage_s, "stages_device_s": extra["stages_device_s"],
           "launches": launches,
           "device": S.device_record(), "scene": sc.record}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
