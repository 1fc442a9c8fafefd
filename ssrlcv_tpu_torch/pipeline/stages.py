"""The reconstruction pipeline with stage-door checkpoint / resume.

Counterpart of ``ssrlcv_tpu/pipeline/stages.py``, with its numbering:

  0 feature generation -> 1 pose estimation (optional, 2 views) -> 2 matching
  -> 3 triangulation -> 4 filtering -> 5 bundle adjustment

Each stage is a function over a ``PipelineState``; with two images the
2-view branch of each stage runs, with more the N-view branch.
``run_pipeline`` runs them in order on the state's device (``cuda:0``
unless the state or the call names another), writes the
initial, filtered and bundle-adjusted clouds as PLY files under
``config.output_dir`` and, with ``config.checkpoint_dir``, checkpoints every
stage and resumes at the first stage without a ``done`` marker.  When image 0
is pushbroom, stage 0 also stacks the pushbroom cameras and stages 3-4
triangulate pushbroom rays; stage 5 and a resume ignore them, as in the JAX
package (ROADMAP.md caveats k, l).

With ``state.mesh`` (a (data, feat) DeviceMesh of ``parallel.mesh``, every
rank of it running ``run_pipeline`` on its own device) the stages take the
JAX package's distributed branches (``parallel.sharded``): image-parallel
SIFT when there are several same-shape images, the sharded 2-view matchers,
the distributed N-view pair sweep, and, for two views, track-sharded
triangulation (not with pushbroom cameras) and bundle adjustment.  Every rank
ends with the same state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig
from ssrlcv_tpu_torch.io import ply
from ssrlcv_tpu_torch.logging import logger
from ssrlcv_tpu_torch.core.device import resolve_device
from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet, MatchSet, PointCloud, PushbroomCameras
from ssrlcv_tpu_torch.io import checkpoint as ckpt
from ssrlcv_tpu_torch.io.images import (cameras_from_refimages,  # noqa: F401  (re-exported)
                                        pushbrooms_from_refimages)

STAGE_FEATURES = 0
STAGE_POSE = 1
STAGE_MATCHING = 2
STAGE_TRIANGULATION = 3
STAGE_FILTERING = 4
STAGE_BUNDLE_ADJUST = 5
NUM_STAGES = 6


@dataclasses.dataclass
class PipelineState:
    config: PipelineConfig
    images: list                                   # list[RefImage]
    device: Optional[torch.device] = None          # None: cuda:0
    cameras: Optional[Cameras] = None
    features: Optional[list] = None                # list[FeatureSet]
    seed_features: Optional[FeatureSet] = None
    seed_distances: Optional[torch.Tensor] = None
    matches: Optional[MatchSet] = None
    cloud: Optional[PointCloud] = None
    ba_error: Optional[tuple] = None               # (initial, final)
    # PushbroomCameras when image 0 is pushbroom (set by stage 0 only)
    pushbrooms: Optional[PushbroomCameras] = None
    # a (data, feat) DeviceMesh (parallel.mesh.make_mesh): the stages then
    # run their distributed twins from parallel/sharded.py over it
    mesh: Optional[object] = None
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)


def _two_view(state: PipelineState) -> bool:
    return len(state.images) == 2


def _pose_runs(state: PipelineState) -> bool:
    return state.config.do_pose and _two_view(state)


def do_feature_generation(state: PipelineState) -> PipelineState:
    """Stage 0: cameras (and the pushbroom cameras when image 0 is
    pushbroom), then SIFT per image, image-parallel over the mesh when there
    is one and the images share a shape."""
    from ssrlcv_tpu_torch.features.sift import generate_features_many

    state.cameras = cameras_from_refimages(state.images, state.device)
    state.pushbrooms = pushbrooms_from_refimages(state.images, state.device)
    pixels = [im.pixels for im in state.images]
    ids = [im.id for im in state.images]
    if (state.mesh is not None and len(state.images) > 1
            and len({np.asarray(p).shape[:2] for p in pixels}) == 1):
        from ssrlcv_tpu_torch.parallel.sharded import sharded_generate_features

        with logger.phase("sift_sharded"):
            state.features = sharded_generate_features(state.mesh, pixels, ids,
                                                       state.config.sift, device=state.device)
    else:
        state.features = generate_features_many(pixels, state.config.sift, image_ids=ids,
                                                device=state.device)
    for im, f in zip(state.images, state.features):
        logger.info(f"image {im.id}: {f.count()} features")
    return state


def do_pose_estimation(state: PipelineState) -> PipelineState:
    """Stage 1 (with ``do_pose`` and two images): refine image 1's pose by LM
    on a match set made with the pose thresholds, and write the refined
    camera back into ``state.images[1]``."""
    if not _pose_runs(state):
        return state
    from ssrlcv_tpu_torch.matching import match as M
    from ssrlcv_tpu_torch.pose.lm import refine_relative_pose

    p = state.config.pose
    mp = MatchParams(relative_threshold=p.relative_threshold,
                     absolute_threshold=p.absolute_threshold, epsilon=p.epsilon, delta=p.delta)
    f0, f1 = state.features
    sd = None
    if state.seed_features is not None:
        sd = M.seed_distances(f0, state.seed_features)
    dm = M.match_double_constrained(f0, f1, state.cameras, 0, 1, mp, seed_dist=sd)
    ms = M.matches_to_matchset(dm, f0, f1, 0, 1)
    with logger.phase("pose_lm"):
        state.cameras = refine_relative_pose(ms, state.cameras, p)
    state.images[1].cam_pos = state.cameras.cam_pos[1].cpu().numpy()
    state.images[1].cam_rot = state.cameras.cam_rot[1].cpu().numpy()
    return state


def do_feature_matching(state: PipelineState) -> PipelineState:
    """Stage 2: seed distances of image 0 (when seed features are set); with
    two images mode "double" matches double-constrained and every other mode
    brute force (as the JAX stage does, "fmatrix" included); with more, the
    exhaustive pair sweep and track building."""
    from ssrlcv_tpu_torch.matching import match as M
    from ssrlcv_tpu_torch.matching.tracks import generate_matches_exhaustive

    cfg = state.config.match
    sd = None
    if state.seed_features is not None:
        sd = M.seed_distances(state.features[0], state.seed_features)
        state.seed_distances = sd
    if _two_view(state):
        f0, f1 = state.features
        if state.mesh is not None:
            from ssrlcv_tpu_torch.parallel import sharded

            if cfg.mode == "double":
                dm = sharded.sharded_match_double_constrained(state.mesh, f0, f1, state.cameras,
                                                              0, 1, cfg, seed_dist=sd)
            else:
                dm = sharded.sharded_match_brute_force(state.mesh, f0, f1, cfg, seed_dist=sd)
        elif cfg.mode == "double":
            dm = M.match_double_constrained(f0, f1, state.cameras, 0, 1, cfg, seed_dist=sd)
        else:
            dm = M.match_brute_force(f0, f1, cfg, seed_dist=sd)
        state.matches = M.matches_to_matchset(dm, f0, f1, 0, 1)
    else:
        state.matches = generate_matches_exhaustive(state.features, state.cameras, cfg,
                                                    seed_features=state.seed_features,
                                                    mesh=state.mesh)
    logger.info(f"total matches: {state.matches.count()}")
    return state


def do_triangulation(state: PipelineState) -> PipelineState:
    """Stage 3: bundles + 2-view or N-view triangulation (track-sharded over
    the mesh for two pinhole views)."""
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches

    if state.mesh is not None and _two_view(state) and state.pushbrooms is None:
        from ssrlcv_tpu_torch.parallel.sharded import sharded_triangulate

        pc, err = sharded_triangulate(state.mesh, state.matches, state.cameras)
    else:
        with logger.span("geometry.triangulate"):
            pc, err = triangulate_matches(state.matches, state.cameras, _two_view(state),
                                          pushbrooms=state.pushbrooms)
    state.cloud = pc
    logger.info(f"initial cloud: {int(pc.mask.sum())} points, error {float(err):.6f}")
    _write_cloud(state, "ssrlcv-initial")
    return state


def do_filtering(state: PipelineState) -> PipelineState:
    """Stage 4: the linear cutoff (2 views only), then the deterministic
    statistical filter; re-triangulate."""
    from ssrlcv_tpu_torch.geometry import filters as F
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches

    cfg = state.config.filter
    two_view = _two_view(state)
    ms = state.matches
    with logger.span("geometry.filter"):
        if two_view:
            ms = F.linear_cutoff_filter(ms, state.cameras, cfg.linear_cutoff_km,
                                        pushbrooms=state.pushbrooms)
        jump = max(int(round(1.0 / cfg.sample_fraction)), 1)
        ms = F.deterministic_statistical_filter(ms, state.cameras, cfg.statistical_sigma, jump,
                                                two_view=two_view, pushbrooms=state.pushbrooms)
    state.matches = ms
    with logger.span("geometry.triangulate"):
        pc, err = triangulate_matches(ms, state.cameras, two_view, pushbrooms=state.pushbrooms)
    state.cloud = pc
    logger.info(f"filtered cloud: {int(pc.mask.sum())} points, error {float(err):.6f}")
    _write_cloud(state, "ssrlcv-filtered")
    return state


def do_bundle_adjust(state: PipelineState) -> PipelineState:
    """Stage 5: 2-view Levenberg-Marquardt, or N-view, bundle adjustment of
    the pinhole cameras (pushbroom cameras are not adjusted: with pushbroom
    images the pinhole fields are zero and the errors NaN, as in the JAX
    package); over the mesh, 2-view LM with the sums taken over its data
    axis."""
    if _two_view(state) and state.mesh is not None:
        from ssrlcv_tpu_torch.parallel.sharded import sharded_bundle_adjust

        result = sharded_bundle_adjust(state.mesh, state.matches, state.cameras,
                                       iterations=state.config.ba.iterations,
                                       fix_camera0=state.config.ba.fixed_camera)
    elif _two_view(state):
        from ssrlcv_tpu_torch.ba.two_view import bundle_adjust

        result = bundle_adjust(state.matches, state.cameras, state.config.ba)
    else:
        from ssrlcv_tpu_torch.ba.nview import bundle_adjust_nview

        result = bundle_adjust_nview(state.matches, state.cameras, state.config.ba)
    state.cameras = result.cameras
    state.cloud = result.cloud
    # the errors and the accepted steps in one read from the device
    e0, e1, accepted = torch.stack([result.initial_error, result.final_error,
                                    result.accepted.to(result.final_error.dtype)]).tolist()
    state.ba_error = (e0, e1)
    iterations = state.config.ba.iterations
    do_bundle_adjust.iterations += iterations
    do_bundle_adjust.graphed_iterations += iterations if result.graphed else 0
    do_bundle_adjust.accepted += int(accepted)
    do_bundle_adjust.two_view_calls += int(_two_view(state))
    do_bundle_adjust.column_cameras += int(result.column_cameras)
    logger.info(f"bundle adjust: {e0!r} -> {e1!r} "
                f"({int(accepted)} of {iterations} steps accepted)")
    _write_cloud(state, "ssrlcv-BA-final")
    return state


# LM iterations run, those whose derivatives replayed CUDA graphs, and steps
# accepted by every do_bundle_adjust call; its 2-view calls, and those whose
# objective reached the cameras by view column
do_bundle_adjust.iterations = 0
do_bundle_adjust.graphed_iterations = 0
do_bundle_adjust.accepted = 0
do_bundle_adjust.two_view_calls = 0
do_bundle_adjust.column_cameras = 0


def _write_cloud(state: PipelineState, name: str):
    with logger.span("io.write_ply"):
        pts = state.cloud.compact()
        path = os.path.join(state.config.output_dir, name)
        ply.write_ply(path, pts)
    logger.info(f"wrote {path}.ply ({len(pts)} points)")


STAGES = [
    ("features", do_feature_generation),
    ("pose", do_pose_estimation),
    ("matching", do_feature_matching),
    ("triangulation", do_triangulation),
    ("filtering", do_filtering),
    ("bundle_adjust", do_bundle_adjust),
]


def first_stage(state: PipelineState) -> int:
    """The stage ``run_pipeline`` starts at: the first without a done marker
    under the checkpoint directory, 0 without one."""
    root = state.config.checkpoint_dir
    return ckpt.first_unfinished_stage(root, NUM_STAGES) if root else 0


def run_pipeline(state: PipelineState, device=None) -> PipelineState:
    """Run the stages in order on ``device`` (default: the state's), from
    the last checkpoint when the config names a checkpoint directory.  Each
    stage that runs puts its seconds in ``state.stage_seconds`` (the pose
    stage only when it estimates a pose): on a CUDA device from CUDA events
    read after one synchronisation at the end, so the stages run without
    added synchronisation.  Each stage is also a span of its name
    (``logger.span``)."""
    if device is not None:
        state.device = resolve_device(device)
    root = state.config.checkpoint_dir
    start = first_stage(state)
    if start > 0:
        logger.info(f"resuming at stage {start}")
        _restore(state, root, start)
    cuda = state.device.type == "cuda"
    marks = []
    for i in range(start, NUM_STAGES):
        name, fn = STAGES[i]
        logger.log_state(f"stage{i}:{name}:begin")
        with logger.span(name):
            if i == STAGE_POSE and not _pose_runs(state):
                state = fn(state)
            elif cuda:
                start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                stream = torch.cuda.current_stream(state.device)
                start_ev.record(stream)
                state = fn(state)
                end_ev.record(stream)
                marks.append((name, start_ev, end_ev))
            else:
                t0 = time.perf_counter()
                state = fn(state)
                state.stage_seconds[name] = time.perf_counter() - t0
        logger.log_state(f"stage{i}:{name}:end")
        if root:
            _checkpoint(state, root, i)
    if cuda:
        torch.cuda.synchronize(state.device)
        for name, start_ev, end_ev in marks:
            state.stage_seconds[name] = start_ev.elapsed_time(end_ev) / 1000.0
    logger.info(f"stage seconds {json.dumps(state.stage_seconds)}")
    return state


def _checkpoint(state: PipelineState, root: str, stage: int):
    tree = {}
    if state.cameras is not None:
        tree["cameras"] = state.cameras
    if state.features is not None and stage <= STAGE_POSE:
        for j, f in enumerate(state.features):
            tree[f"features{j}"] = f
    meta = {"stage": stage}
    if state.matches is not None and stage >= STAGE_MATCHING:
        tree["matches"] = state.matches
        meta["match_capacity"] = state.matches.capacity
        meta["match_views"] = state.matches.max_views
    if state.cloud is not None and stage >= STAGE_TRIANGULATION:
        tree["cloud"] = state.cloud
    ckpt.save_stage(root, stage, "state", tree, meta=meta)


def _restore(state: PipelineState, root: str, start: int):
    """Rebuild the state from the last finished stage's checkpoint, on the
    state's device.  ``state.pushbrooms`` is not rebuilt (only stage 0 sets
    it), so a run resumed at stage >= 1 triangulates with pinhole bundles,
    as in the JAX package (ROADMAP.md caveat l)."""
    last, dev = start - 1, state.device
    like = {"cameras": cameras_from_refimages(state.images, "cpu")}
    if last <= STAGE_POSE:
        cap = state.config.sift.max_keypoints
        for j, im in enumerate(state.images):
            like[f"features{j}"] = FeatureSet.empty(cap, parent=im.id)
    if last >= STAGE_MATCHING:
        meta = ckpt.load_stage_meta(root, last) or {}
        cap = meta.get("match_capacity")
        if cap is None:
            # a checkpoint written before meta.json recorded the capacity:
            # the leading dimension of the first 3-D array (matches.kp_loc)
            with np.load(os.path.join(ckpt.stage_dir(root, last), "state.npz")) as z:
                caps = [z[k].shape[0] for k in z.files if z[k].ndim == 3]
            cap = caps[0] if caps else 128
        like["matches"] = MatchSet.empty(cap, meta.get("match_views", 2))
    if last >= STAGE_TRIANGULATION:
        t = like["matches"].capacity
        like["cloud"] = PointCloud(points=torch.zeros((t, 3)), errors=torch.zeros((t,)),
                                   mask=torch.zeros((t,), dtype=torch.bool))
    loaded = ckpt.load_stage(root, last, "state", like, device=dev)
    state.cameras = loaded["cameras"]
    if last <= STAGE_POSE:
        state.features = [loaded[f"features{j}"] for j in range(len(state.images))]
    if last >= STAGE_MATCHING:
        state.matches = loaded["matches"]
    if last >= STAGE_TRIANGULATION:
        state.cloud = loaded["cloud"]
