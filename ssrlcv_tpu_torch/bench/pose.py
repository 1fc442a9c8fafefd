"""The pose stage on one CUDA device, and the reconstruction after it.

    python -m ssrlcv_tpu_torch.bench.pose [--fixture DIR] [--size N] [--seed S]

Counterpart of ``scripts/bench_pose_tpu.py``: SIFT of the pair and seed
distances; double-constrained matching at the pose thresholds of
``PoseParams`` (relative 0.6, absolute 10^2, epsilon 100 px, delta 3 km);
the LM relative-pose refinement (``pose.lm.lm_optimize``), timed as the
least of three runs after a warm-up, each on the host clock to a
``synchronize`` (with no pose match the LM has nothing to refine: the
record's ``value`` is then null, with a ``note``); the pose written into camera 1; then matching again at
epsilon 25 px, delta 5 km under the refined camera and triangulation.  The
pose has no anchor (ROADMAP caveat f): the post-pose cloud is held to the
JAX package's output, not to a truth, and its distance to the truth is
reported only.  Prints one JSON record as the last line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ssrlcv_tpu_torch.bench import scene as S
from ssrlcv_tpu_torch.config import MatchParams, PoseParams


def pose_matches(f0, f1, cams, sd, pp: PoseParams = PoseParams()):
    """The MatchSet the pose stage refines on: matching at the pose
    thresholds."""
    from ssrlcv_tpu_torch.matching import match as M

    mp = MatchParams(relative_threshold=pp.relative_threshold,
                     absolute_threshold=pp.absolute_threshold, epsilon=pp.epsilon, delta=pp.delta)
    return M.matches_to_matchset(M.match_double_constrained(f0, f1, cams, 0, 1, mp, seed_dist=sd),
                                 f0, f1, 0, 1)


def post_pose(f0, f1, cams, new_cams, sd) -> dict:
    """Matching again under the refined cameras (epsilon 25 px, delta 5
    km) and triangulation: JAX's post-pose fields, and the cloud."""
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.matching import match as M

    dm = M.match_double_constrained(f0, f1, new_cams, 0, 1, MatchParams(epsilon=25.0, delta=5.0),
                                    seed_dist=sd)
    ms = M.matches_to_matchset(dm, f0, f1, 0, 1)
    pc, err = triangulate_matches(ms, new_cams)
    shift = (new_cams.cam_pos[1] - cams.cam_pos[1]).double().norm()
    return {"cam1_pos_shift_m": float(shift) * 1000.0, "post_pose_matches": ms.count(),
            "post_pose_points": int(pc.mask.sum()), "post_pose_total_linear_error": float(err),
            "cloud": pc}


def main(argv=None, synthetic=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.bench.pose",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", help="a Pipeline2View fixture directory")
    ap.add_argument("--size", type=int, default=1024, help="synthetic scene size")
    ap.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    args = ap.parse_args(argv)
    dev = S.require_cuda(ap.prog)
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms
    from ssrlcv_tpu_torch.features.sift import generate_features_many
    from ssrlcv_tpu_torch.matching import match as M
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.pose.lm import apply_pose, lm_optimize

    sc = S.load(args.fixture, args.size, args.seed, 2, dev, synthetic=synthetic)
    counters = (orientation_histograms, descriptor_histograms, best_target)
    for fn in counters:
        fn.launches = 0
    f0, f1 = generate_features_many([im.pixels for im in sc.images], image_ids=[0, 1],
                                    device=dev)
    sd = M.seed_distances(f0, sc.seed)
    pp = PoseParams()
    ms = pose_matches(f0, f1, sc.cameras, sd, pp)
    n_pose = ms.count()
    if n_pose:
        pose, best = S.min_seconds(lambda: lm_optimize(ms, sc.cameras, pp), dev)
        note = {}
    else:
        pose, best = lm_optimize(ms, sc.cameras, pp), None
        note = {"note": "no pair passes the pose stage's thresholds on this scene: the LM has "
                        "no match to refine on, so the record times nothing (value null)"}
    new_cams = apply_pose(sc.cameras, pose)
    post = post_pose(f0, f1, sc.cameras, new_cams, sd)
    pc = post.pop("cloud")
    d = sc.distance_m(pc.points[pc.mask])
    out = {"metric": "pose_stage_device_s", "value": best, "unit": "s",
           "pose_matches": n_pose, **note,
           "pose_rot": [float(v) for v in pose.rot.cpu()],
           "pose_pos": [float(v) for v in pose.pos.cpu()], **post,
           f"post_pose_cloud_vs_{sc.truth}_m_median": float(np.median(d)) if len(d) else None,
           "launches": {fn.__name__: fn.launches for fn in counters},
           "device": S.device_record(), "scene": sc.record}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
