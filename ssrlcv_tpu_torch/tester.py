"""The reference's second executable (``src/Tester.cu:36-120``) on one CUDA
device: the logger and the 2-view match -> triangulate path.

    python -m ssrlcv_tpu_torch.tester [--fixture DIR] [--size N] [--seed S] [--out DIR]

Counterpart of ``scripts/tester.py``.  It opens the CSV log under ``--out``
with a ``start`` state row and a heartbeat every second, loads the scene
(rendering the synthetic one takes seconds, so the log beats there), runs
the seed-distance pass (K3) of the seed features against themselves, then ``generate_bundles`` + ``two_view_triangulate`` on
a MatchSet: with ``--fixture`` (the reference's Pipeline2View layout) the
fixture's ``keypoints0`` / ``multimatches0``, as the JAX script; on the
synthetic scene the match set of the 2-view main path (SIFT of both
images, seed distances, double-constrained matching at epsilon 25 px,
delta 5 km).  It stops the heartbeat, writes the ``end`` row, prints the
JAX script's line and then one JSON record as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ssrlcv_tpu_torch.bench import scene as S


def main_path_matchset(f0, f1, seed, cams):
    """The 2-view main path's MatchSet (before the filters) of the feature
    sets ``f0``, ``f1``: seed distances, then double-constrained
    matching."""
    from ssrlcv_tpu_torch.config import MatchParams
    from ssrlcv_tpu_torch.matching import match as M

    sd = M.seed_distances(f0, seed)
    dm = M.match_double_constrained(f0, f1, cams, 0, 1, MatchParams(epsilon=25.0, delta=5.0),
                                    seed_dist=sd)
    return M.matches_to_matchset(dm, f0, f1, 0, 1)


def triangulate(ms, cams):
    """(matches, total linear error) of ``generate_bundles`` +
    ``two_view_triangulate`` on ``ms``."""
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import two_view_triangulate

    _, total_err = two_view_triangulate(generate_bundles(ms, cams))
    return ms.count(), float(total_err)


def main(argv=None, synthetic=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.tester",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", help="a Pipeline2View fixture directory")
    ap.add_argument("--size", type=int, default=1024, help="synthetic scene size")
    ap.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    ap.add_argument("--out", default="out", help="the log's directory")
    args = ap.parse_args(argv)
    dev = S.require_cuda(ap.prog)
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.features.sift import generate_features_many
    from ssrlcv_tpu_torch.logging import Logger
    from ssrlcv_tpu_torch.matching import match as M
    from ssrlcv_tpu_torch.matching.match_kernel import best_target

    logger = Logger(args.out)
    logger.log_state("start")
    logger.start_background_logging(1.0)
    sc = S.load(args.fixture, args.size, args.seed, 2, dev, synthetic=synthetic)
    n_seed = sc.seed.count()
    logger.info(f"loaded the scene: {n_seed} seed features")

    best_target.launches = 0
    logger.log_state("matching start")
    t0 = time.perf_counter()
    M.seed_distances(sc.seed, sc.seed)
    S.sync(dev)
    seed_s = time.perf_counter() - t0
    logger.log_state("matching end")
    logger.info(f"seed-distance pass over {n_seed} features in {seed_s:.3f}s")

    if sc.fixture is not None:
        kp_par, kp_loc = sc.fixture["keypoints0"]
        mm_num, mm_idx = sc.fixture["multimatches0"]
        ms = MatchSet.from_flat(kp_par, kp_loc, mm_num, mm_idx, device=dev)
    else:
        f0, f1 = generate_features_many([im.pixels for im in sc.images], image_ids=[0, 1],
                                        device=dev)
        ms = main_path_matchset(f0, f1, sc.seed, sc.cameras)
    logger.log_state("triangulate start")
    t0 = time.perf_counter()
    n, err = triangulate(ms, sc.cameras)
    tri_s = time.perf_counter() - t0
    logger.log_state("triangulate end")
    logger.info(f"triangulated {n} points, linear error {err:.6f} km^2 in {tri_s:.3f}s")
    logger.log_device_memory()
    logger.stop_background_logging()
    logger.log_state("end")
    logger.close()
    print(f"tester: {n} matches, linear error {err:.6f}, log at {logger.path}")
    out = {"metric": "tester_matches", "value": n, "unit": "matches", "linear_error": err,
           "seed_features": n_seed, "seed_pass_s": seed_s, "triangulate_s": tri_s,
           "log": os.path.abspath(logger.path), "launches": {"best_target": best_target.launches},
           "device": S.device_record(), "scene": sc.record}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
