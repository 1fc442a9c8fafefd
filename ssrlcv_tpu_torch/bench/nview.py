"""The 3-view N-view pipeline end to end on one CUDA device.

    python -m ssrlcv_tpu_torch.bench.nview [--fixture DIR] [--size N] [--seed S]

Counterpart of ``scripts/bench_nview_tpu.py``: SIFT of the three images ->
the exhaustive seeded double-constrained pair sweep (epsilon 25 px, delta 5
km) and track building -> N-view triangulation -> the N-view statistical
filter (3 sigma, every 10th) and its re-triangulation -> N-view BA (5
iterations).  One run warms up; the next is timed stage by stage on the
host clock, each stage ending in a ``synchronize``.  The scene is the
synthetic one (three views) unless ``--fixture`` names the reference's
``test/checkpoints/Pipeline3View`` layout, which adds the golden track
counts and distances to its golden clouds (``golden_*``); on the synthetic
scene the distances are to its true surface.  N-view BA may take no step
(ROADMAP caveat e): the record shows it as initial = final error.  Prints
one JSON record as the last line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ssrlcv_tpu_torch.bench import scene as S
from ssrlcv_tpu_torch.config import MatchParams, SIFTParams


def run(images, cams, seed, sift_params: SIFTParams = SIFTParams(), timings=None):
    """The five stages on the device of ``cams``: returns (features,
    tracks, triangulated cloud, filtered tracks, their cloud, BA result).  With
    ``timings`` each stage ends in a synchronisation and its host seconds
    go there (sift3, match_tracks, triangulate, filter, bundle_adjust,
    total)."""
    from ssrlcv_tpu_torch.ba.nview import bundle_adjust_nview
    from ssrlcv_tpu_torch.config import BAParams
    from ssrlcv_tpu_torch.features.sift import generate_features_many
    from ssrlcv_tpu_torch.geometry import filters as F
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.matching.tracks import generate_matches_exhaustive

    dev = cams.cam_pos.device
    marks = [time.perf_counter()]

    def mark():
        if timings is not None:
            S.sync(dev)
            marks.append(time.perf_counter())

    feats = generate_features_many([im.pixels for im in images], sift_params,
                                   image_ids=list(range(len(images))), device=dev)
    mark()
    ms = generate_matches_exhaustive(feats, cams, MatchParams(epsilon=25.0, delta=5.0),
                                     seed_features=seed)
    mark()
    pc, _ = triangulate_matches(ms, cams, two_view=False)
    mark()
    ms_f = F.deterministic_statistical_filter(ms, cams, 3.0, 10, two_view=False)
    pc_f, _ = triangulate_matches(ms_f, cams, two_view=False)
    mark()
    ba = bundle_adjust_nview(ms_f, cams, BAParams(iterations=5))
    mark()
    if timings is not None:
        names = ("sift3", "match_tracks", "triangulate", "filter", "bundle_adjust")
        timings.update({k: b - a for k, a, b in zip(names, marks, marks[1:])},
                       total=marks[-1] - marks[0])
    return feats, ms, pc, ms_f, pc_f, ba


def summary(sc, ms, pc, ms_f, pc_f, ba) -> dict:
    """Track counts, BA errors and the clouds' median distances to the
    truth (with a fixture also the golden counts): JAX's field names."""
    truth = sc.truth

    def median(points, mask, golden):
        pts = points[mask]
        return float(np.median(sc.distance_m(pts, golden))) if pts.shape[0] else None

    d = sc.distance_m(pc.points[pc.mask], "points0")
    out = {"tracks": ms.count(), "filtered_tracks": ms_f.count(),
           f"cloud_vs_{truth}_m_median": float(np.median(d)) if len(d) else None,
           "cloud_within_100m_pct": 100.0 * float((d < 100.0).mean()) if len(d) else None,
           f"filtered_vs_{truth}_m_median": median(pc_f.points, pc_f.mask, "points1"),
           "ba_initial_error": float(ba.initial_error), "ba_final_error": float(ba.final_error),
           f"ba_cloud_vs_{truth}_m_median": median(ba.cloud.points, ba.cloud.mask, "points0")}
    if sc.fixture is not None:
        golden, golden_f = len(sc.fixture["multimatches0"][0]), sc.fixture["points1"].shape[0]
        out.update(golden_tracks=golden, golden_filtered=golden_f,
                   track_err_pct=100.0 * abs(out["tracks"] - golden) / golden,
                   filtered_err_pct=100.0 * abs(out["filtered_tracks"] - golden_f) / golden_f)
    return out


def main(argv=None, synthetic=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.bench.nview",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", help="a Pipeline3View fixture directory")
    ap.add_argument("--size", type=int, default=1024, help="synthetic scene size")
    ap.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    args = ap.parse_args(argv)
    dev = S.require_cuda(ap.prog)
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.matching.match_kernel import best_target

    sc = S.load(args.fixture, args.size, args.seed, 3, dev, synthetic=synthetic)
    counters = (orientation_histograms, descriptor_histograms, best_target)
    for fn in counters:
        fn.launches = 0
    run(sc.images, sc.cameras, sc.seed)  # warm-up
    timings = {}
    result = run(sc.images, sc.cameras, sc.seed, timings=timings)
    out = {"metric": "nview_3view_fps", "value": 3.0 / timings["total"], "unit": "frames/s",
           "e2e_seconds": timings["total"],
           "stages_s": {k: v for k, v in timings.items() if k != "total"},
           **summary(sc, *result[1:]),
           "launches": {fn.__name__: fn.launches for fn in counters},
           "device": S.device_record(), "scene": sc.record}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
