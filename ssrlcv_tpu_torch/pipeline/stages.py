"""The 2-view reconstruction pipeline.

Counterpart of the 2-view branches of ``ssrlcv_tpu/pipeline/stages.py``:

  0 feature generation -> 2 matching -> 3 triangulation -> 4 filtering
  -> 5 bundle adjustment

Each stage is a function over a ``PipelineState``; ``run_pipeline`` runs
them in order on the state's device and writes the initial, filtered and
bundle-adjusted clouds as PLY files under ``config.output_dir``.  Pinhole
cameras and two images only; pose estimation (stage 1), N-view, pushbroom
cameras, mesh sharding and checkpoint/resume are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ssrlcv_tpu.config import PipelineConfig
from ssrlcv_tpu.io import ply
from ssrlcv_tpu.io.refdata import RefImage
from ssrlcv_tpu.logging import logger
from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet, MatchSet, PointCloud


@dataclasses.dataclass
class PipelineState:
    config: PipelineConfig
    images: list                                   # list[RefImage], two of them
    device: torch.device = torch.device("cpu")
    cameras: Optional[Cameras] = None
    features: Optional[list] = None                # list[FeatureSet]
    seed_features: Optional[FeatureSet] = None
    seed_distances: Optional[torch.Tensor] = None
    matches: Optional[MatchSet] = None
    cloud: Optional[PointCloud] = None
    ba_error: Optional[tuple] = None               # (initial, final)
    stage_seconds: dict = dataclasses.field(default_factory=dict)


def cameras_from_refimages(images: Iterable[RefImage], device=None) -> Cameras:
    """Stack host RefImages into batched Cameras on ``device``."""
    ims = list(images)
    return Cameras.from_numpy(
        device=device,
        cam_pos=np.stack([im.cam_pos for im in ims]).astype(np.float32),
        cam_rot=np.stack([im.cam_rot for im in ims]).astype(np.float32),
        fov=np.stack([im.fov for im in ims]).astype(np.float32),
        foc=np.array([im.foc for im in ims], np.float32),
        dpix=np.stack([im.dpix for im in ims]).astype(np.float32),
        size=np.array([[im.size[0], im.size[1]] for im in ims], np.int32),
        ecef_offset=np.stack([im.ecef_offset for im in ims]).astype(np.float32),
        timestamp=np.array([im.timestamp for im in ims], np.int64),
    )


def _check_two_view(state: PipelineState):
    if len(state.images) != 2:
        raise NotImplementedError(f"only the 2-view pipeline is ported; got "
                                  f"{len(state.images)} images")
    if any(im.is_pushbroom for im in state.images):
        raise NotImplementedError("pushbroom cameras are not ported")


def do_feature_generation(state: PipelineState) -> PipelineState:
    """Stage 0: cameras, then SIFT per image."""
    from ssrlcv_tpu_torch.features.sift import generate_features_many

    _check_two_view(state)
    state.cameras = cameras_from_refimages(state.images, state.device)
    state.features = generate_features_many(
        [im.pixels for im in state.images], state.config.sift,
        image_ids=[im.id for im in state.images], device=state.device)
    for im, f in zip(state.images, state.features):
        logger.info(f"image {im.id}: {f.count()} features")
    return state


def do_feature_matching(state: PipelineState) -> PipelineState:
    """Stage 2: seed distances (when seed features are set), then mode
    "double" matches double-constrained and every other mode brute force (as
    the JAX stage does, "fmatrix" included), then match-set assembly."""
    from ssrlcv_tpu_torch.matching import match as M

    cfg = state.config.match
    sd = None
    if state.seed_features is not None:
        sd = M.seed_distances(state.features[0], state.seed_features)
        state.seed_distances = sd
    f0, f1 = state.features
    if cfg.mode == "double":
        dm = M.match_double_constrained(f0, f1, state.cameras, 0, 1, cfg, seed_dist=sd)
    else:
        dm = M.match_brute_force(f0, f1, cfg, seed_dist=sd)
    state.matches = M.matches_to_matchset(dm, f0, f1, 0, 1)
    logger.info(f"total matches: {state.matches.count()}")
    return state


def do_triangulation(state: PipelineState) -> PipelineState:
    """Stage 3: bundles + 2-view triangulation."""
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches

    pc, err = triangulate_matches(state.matches, state.cameras)
    state.cloud = pc
    logger.info(f"initial cloud: {int(pc.mask.sum())} points, error {float(err):.6f}")
    _write_cloud(state, "ssrlcv-initial")
    return state


def do_filtering(state: PipelineState) -> PipelineState:
    """Stage 4: linear cutoff, then the deterministic statistical filter;
    re-triangulate."""
    from ssrlcv_tpu_torch.geometry import filters as F
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches

    cfg = state.config.filter
    ms = F.linear_cutoff_filter(state.matches, state.cameras, cfg.linear_cutoff_km)
    jump = max(int(round(1.0 / cfg.sample_fraction)), 1)
    ms = F.deterministic_statistical_filter(ms, state.cameras, cfg.statistical_sigma, jump)
    state.matches = ms
    pc, err = triangulate_matches(ms, state.cameras)
    state.cloud = pc
    logger.info(f"filtered cloud: {int(pc.mask.sum())} points, error {float(err):.6f}")
    _write_cloud(state, "ssrlcv-filtered")
    return state


def do_bundle_adjust(state: PipelineState) -> PipelineState:
    """Stage 5: 2-view Levenberg-Marquardt bundle adjustment."""
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust_two_view

    result = bundle_adjust_two_view(state.matches, state.cameras,
                                    iterations=state.config.ba.iterations, mode="lm",
                                    fix_camera0=state.config.ba.fixed_camera)
    state.cameras = result.cameras
    state.cloud = result.cloud
    state.ba_error = (float(result.initial_error), float(result.final_error))
    logger.info(f"bundle adjust: {state.ba_error[0]:.6f} -> {state.ba_error[1]:.6f}")
    _write_cloud(state, "ssrlcv-BA-final")
    return state


def _write_cloud(state: PipelineState, name: str):
    pts = state.cloud.compact()
    path = os.path.join(state.config.output_dir, name)
    ply.write_ply(path, pts)
    logger.info(f"wrote {path}.ply ({len(pts)} points)")


STAGES = [
    ("features", do_feature_generation),
    ("matching", do_feature_matching),
    ("triangulation", do_triangulation),
    ("filtering", do_filtering),
    ("bundle_adjust", do_bundle_adjust),
]


def run_pipeline(state: PipelineState, device=None) -> PipelineState:
    """Run the stages in order on ``device`` (default: the state's).  Each
    stage's seconds land in ``state.stage_seconds``: on a CUDA device from
    CUDA events read after one synchronisation at the end, so the stages
    run without added synchronisation."""
    if device is not None:
        state.device = torch.device(device)
    cuda = state.device.type == "cuda"
    marks = []
    for name, fn in STAGES:
        logger.log_state(f"{name}:begin")
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            stream = torch.cuda.current_stream(state.device)
            start.record(stream)
            state = fn(state)
            end.record(stream)
            marks.append((name, start, end))
        else:
            t0 = time.perf_counter()
            state = fn(state)
            state.stage_seconds[name] = time.perf_counter() - t0
        logger.log_state(f"{name}:end")
    if cuda:
        torch.cuda.synchronize(state.device)
        for name, start, end in marks:
            state.stage_seconds[name] = start.elapsed_time(end) / 1000.0
    return state
