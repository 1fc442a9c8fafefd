"""One reconstruction job of the reference, stage by stage as
``ssrlcv_tpu_torch.pipeline.stages.run_pipeline`` defines it (no pose
stage, no checkpoints, no mesh): seed SIFT, SIFT of every view, matching
(2 views: the seed pass and the double-constrained match in mode "double",
brute force otherwise; more views: the exhaustive pair sweep and
``build_tracks``), triangulation, filtering (2 views: the linear cutoff;
then the deterministic statistical filter) and re-triangulation, bundle
adjustment (2 views: LM; more: N-view)."""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.config import PipelineConfig
from benchmark.reference.core.types import Cameras, FeatureSet, MatchSet, PointCloud


@dataclasses.dataclass
class Outputs:
    """What a job produced, stage by stage."""

    features: list                  # [FeatureSet] of the views (stage 0)
    seed_features: FeatureSet       # of the seed image
    matches: MatchSet               # stage 2
    initial: PointCloud             # stage 3: the matches' cloud
    filtered: MatchSet              # stage 4's tracks
    cloud: PointCloud               # stage 4's cloud
    ba_cameras: object              # stage 5: cameras (Cameras-like)
    ba_cloud: PointCloud            # stage 5: the adjusted cloud
    ba_error: tuple                 # stage 5: (initial, final)


def cameras_of(views, device) -> Cameras:
    """Stack the views' pinhole cameras on ``device``."""
    return Cameras.from_numpy(
        device=device,
        cam_pos=np.stack([v.cam_pos for v in views]).astype(np.float32),
        cam_rot=np.stack([v.cam_rot for v in views]).astype(np.float32),
        fov=np.stack([v.fov for v in views]).astype(np.float32),
        foc=np.array([v.foc for v in views], np.float32),
        dpix=np.stack([v.dpix for v in views]).astype(np.float32),
        size=np.array([[v.size[0], v.size[1]] for v in views], np.int32),
        ecef_offset=np.stack([v.ecef_offset for v in views]).astype(np.float32),
        timestamp=np.array([v.timestamp for v in views], np.int64),
    )


def sift(pixels, config: PipelineConfig, image_id: int, device) -> FeatureSet:
    from benchmark.reference.features.sift import generate_features

    return generate_features(pixels, config.sift, image_id=image_id, device=device)


def match(features: list, seed_features: FeatureSet, cameras: Cameras,
          config: PipelineConfig) -> MatchSet:
    """Stage 2 on given features (the reference's or, to follow the program
    a stage at a time, the program's)."""
    from benchmark.reference.matching import match as M
    from benchmark.reference.matching.tracks import generate_matches_exhaustive

    cfg = config.match
    if len(features) == 2:
        f0, f1 = features
        sd = M.seed_distances(f0, seed_features)
        if cfg.mode == "double":
            dm = M.match_double_constrained(f0, f1, cameras, 0, 1, cfg, seed_dist=sd)
        else:
            dm = M.match_brute_force(f0, f1, cfg, seed_dist=sd)
        return M.matches_to_matchset(dm, f0, f1, 0, 1)
    return generate_matches_exhaustive(features, cameras, cfg, seed_features=seed_features)


def triangulate(matches: MatchSet, cameras: Cameras) -> PointCloud:
    """Stage 3: the matches' cloud."""
    from benchmark.reference.geometry.triangulation import triangulate_matches

    return triangulate_matches(matches, cameras, cameras.num_cameras == 2)[0]


def filter_tracks(matches: MatchSet, cameras: Cameras, config: PipelineConfig):
    """Stages 3-4: the filters, then the filtered tracks' cloud."""
    from benchmark.reference.geometry import filters as F
    from benchmark.reference.geometry.triangulation import triangulate_matches

    cfg = config.filter
    two_view = cameras.num_cameras == 2
    ms = matches
    if two_view:
        ms = F.linear_cutoff_filter(ms, cameras, cfg.linear_cutoff_km)
    jump = max(int(round(1.0 / cfg.sample_fraction)), 1)
    ms = F.deterministic_statistical_filter(ms, cameras, cfg.statistical_sigma, jump,
                                            two_view=two_view)
    pc, _ = triangulate_matches(ms, cameras, two_view)
    return ms, pc


def bundle_adjust(matches: MatchSet, cameras: Cameras, config: PipelineConfig):
    """Stage 5: (cameras, cloud, (initial, final error))."""
    if cameras.num_cameras == 2:
        from benchmark.reference.ba.two_view import bundle_adjust as ba2

        r = ba2(matches, cameras, config.ba)
    else:
        from benchmark.reference.ba.nview import bundle_adjust_nview

        r = bundle_adjust_nview(matches, cameras, config.ba)
    return r.cameras, r.cloud, (float(r.initial_error), float(r.final_error))


def reconstruct(views, seed_pixels, config: PipelineConfig, device) -> Outputs:
    """The whole job from the views (objects with ``pixels`` and the pinhole
    camera fields) and the seed image's pixels."""
    cams = cameras_of(views, device)
    seed = sift(seed_pixels, config, -1, device)
    feats = [sift(v.pixels, config, i, device) for i, v in enumerate(views)]
    ms = match(feats, seed, cams, config)
    initial = triangulate(ms, cams)
    filtered, cloud = filter_tracks(ms, cams, config)
    ba_cams, ba_cloud, ba_err = bundle_adjust(filtered, cams, config)
    return Outputs(features=feats, seed_features=seed, matches=ms, initial=initial,
                   filtered=filtered, cloud=cloud, ba_cameras=ba_cams, ba_cloud=ba_cloud,
                   ba_error=ba_err)
