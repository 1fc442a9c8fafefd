"""SfM command-line entry point of the port.

Counterpart of ``ssrlcv_tpu/pipeline/sfm.py``: parse the arguments, load the
directory's images and params.csv, run the six-stage pipeline with
stage-door checkpoint/resume, and write the initial, filtered and
bundle-adjusted clouds as PLY files.  SIGINT flushes the log and exits; the
stage checkpoints on disk stay resumable.

Usage:
    python -m ssrlcv_tpu_torch.pipeline.sfm -d <image_dir> [-s <seed_image>]
        [--epsilon E] [--delta D] [-cpdir DIR] [--pose] [-np] [-o DIR]
        [--mesh DATAxFEAT | auto] [--device DEV]

``--device`` defaults to ``cuda:0``; without a CUDA device the run stops
(``--device cpu`` runs on the CPU).

``--mesh`` runs the distributed stages (``parallel.sharded``) over a
(data, feat) mesh of ``torch.distributed`` ranks, one device each; ``auto``
puts every rank on the data axis.  Under torchrun (``WORLD_SIZE`` > 1) every
process joins the group (NCCL on the card, gloo with ``--device cpu``), runs
on ``cuda:{LOCAL_RANK}`` and writes to ``<output>-p{rank}`` and
``<checkpoint>-p{rank}``:

    torchrun --nproc-per-node 4 -m ssrlcv_tpu_torch.pipeline.sfm -d DIR --mesh 2x2

In one process, ``--mesh auto`` (or ``1x1``) starts a one-rank group itself
and runs the same stages over a 1 x 1 mesh.
"""

from __future__ import annotations

import argparse
import signal
import sys

import torch
import torch.distributed as dist

from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig
from ssrlcv_tpu_torch.core.device import resolve_device
from ssrlcv_tpu_torch.logging import logger
from ssrlcv_tpu_torch.parallel import mesh as pm


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX command line's flags and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(prog="ssrlcv-sfm-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--directory", required=True, help="directory of images + params.csv")
    p.add_argument("-i", "--image", action="append", default=[],
                   help="individual image path (accepted and unused, as by the JAX command line)")
    p.add_argument("-s", "--seed", default=None, help="seed image path")
    p.add_argument("--epsilon", type=float, default=5.0, help="epipolar tube half-width, px")
    p.add_argument("--delta", type=float, default=0.0, help="Earth-radius slack, km")
    p.add_argument("-cpdir", "--checkpoint-dir", default=None, help="checkpoint/resume directory")
    p.add_argument("--pose", action="store_true",
                   help="run pose estimation (stage 1) on a 2-image directory")
    p.add_argument("-np", "--noparams", action="store_true", help="skip params.csv")
    p.add_argument("-o", "--output-dir", default="out")
    p.add_argument("--mesh", default=None, metavar="DATAxFEAT",
                   help="run the distributed stages over a (data, feat) mesh of ranks, "
                        "e.g. '2x2'; 'auto' = every rank on the data axis")
    p.add_argument("--device", default="cuda:0", help="torch device (default cuda:0)")
    return p.parse_args(argv)


def _mesh_shape(spec: str):
    """(data, feat) of a --mesh value; data None for 'auto'."""
    if spec == "auto":
        return None, 1
    try:
        data, feat = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh must be DATAxFEAT or auto, got {spec!r}") from None
    return data, feat


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    # under torchrun: join the group (a no-op in one process)
    joined = pm.initialize_distributed(backend=backend)
    try:
        if dist.is_initialized() and dist.get_world_size() > 1:
            # one process per device: every process runs the same pipeline
            # and writes the same artifacts, each to its own directories
            sfx = f"-p{dist.get_rank()}"
            args.output_dir += sfx
            if args.checkpoint_dir:
                args.checkpoint_dir += sfx
            if device.type == "cuda":
                device = torch.device("cuda", pm.local_rank())
                torch.cuda.set_device(device)
        return _logged(args, device, backend)
    finally:
        if joined:
            dist.destroy_process_group()


def _logged(args: argparse.Namespace, device: torch.device, backend: str) -> int:
    logger.close()  # a log opened before this run goes on in its own file
    logger.log_dir = args.output_dir
    logger.path = f"{args.output_dir}/ssrlcv.log"
    logger.log_state("start")
    logger.start_background_logging(1.0)

    def safe_shutdown(signum, frame):
        logger.log_state("SIGINT")
        logger.close()
        sys.exit(130)

    previous = signal.signal(signal.SIGINT, safe_shutdown)
    try:
        with logger.span("sfm"):  # the run: the job of every span inside it
            return _run(args, device, backend)
    finally:
        signal.signal(signal.SIGINT, previous)
        logger.log_state("end")
        logger.close()


def _run(args: argparse.Namespace, device: torch.device, backend: str) -> int:
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.io.images import load_directory, load_image_with_params
    from ssrlcv_tpu_torch.pipeline.stages import (STAGE_MATCHING, PipelineState, first_stage,
                                                  run_pipeline)

    config = PipelineConfig(output_dir=args.output_dir, checkpoint_dir=args.checkpoint_dir,
                            do_pose=args.pose, no_params=args.noparams).replace(
        match=MatchParams(epsilon=args.epsilon, delta=args.delta))
    with logger.phase("load_images"):
        images = load_directory(args.directory, no_params=args.noparams)
    if len(images) < 2:
        logger.err(f"need at least 2 images, found {len(images)}")
        return 1
    logger.info(f"loaded {len(images)} images from {args.directory} onto {device}")

    state = PipelineState(config=config, images=images, device=device)
    # one process: a one-rank group of its own, for the 1 x 1 mesh
    single = bool(args.mesh) and pm.initialize_single(backend)
    try:
        if args.mesh:
            state.mesh = pm.make_mesh(*_mesh_shape(args.mesh), device_type=device.type)
            logger.info("distributed stages over mesh "
                        f"{dict(zip(state.mesh.mesh_dim_names, state.mesh.shape))}")
        # seed features feed the pose and matching stages only: a run
        # resuming past matching does not need them
        if args.seed and first_stage(state) <= STAGE_MATCHING:
            seed_img = load_image_with_params(args.seed, -1, no_params=True)
            with logger.phase("sift_seed"):
                state.seed_features = generate_features(seed_img.pixels, config.sift,
                                                        image_id=-1, device=device)
        run_pipeline(state)
    finally:
        if single:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
