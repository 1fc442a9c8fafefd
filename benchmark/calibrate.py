"""The readings the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

In one process: for each seed, one job of the program on the first scene
of that seed's pool (the window's own call, after one warm job), judged
against the reference's reconstruction of the scene (``compare.readings``),
and the program's own bundle adjustment of the job's filtered tracks in
reversed order, a sound run whose float32 sums go in another order, judged
the same way at stage 5; then for each control seed the control put in the program's place and
judged the same way.  The control is the reference computed one precision
below the configuration's: the scale space's blur, whose every tap the
configuration accumulates as a fused multiply-add (a float64 add rounded
once to float32), in float32 with the product and the sum rounded apart;
and bundle adjustment's rays, float32 arithmetic that no TF32 path
reaches, in bfloat16.
Prints one JSON line per job and, last, each number's lower reading (the
largest over the program's seeds, both orders) and upper reading (the smallest over the
control's).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, harness as H, scene as scene_mod  # noqa: E402


def _taps_float32(pad, taps, axis: int, n: int):
    """The blur's taps in float32: each product and each sum rounded."""
    acc = torch.zeros_like(pad.narrow(axis, 0, n))
    for t, tap in enumerate(taps):
        acc = acc + pad.narrow(axis, t, n) * float(tap)
    return acc


def _bundles_bfloat16(generate):
    """``generate_bundles`` whose rays are rounded to bfloat16."""
    def generate_bfloat16(*args, **kwargs):
        b = generate(*args, **kwargs)
        return b.replace(vec=b.vec.to(torch.bfloat16).to(b.vec.dtype),
                         pnt=b.pnt.to(torch.bfloat16).to(b.pnt.dtype))
    return generate_bfloat16


@contextlib.contextmanager
def control():
    """The reference in the control's precision, while open."""
    from benchmark.reference.ba import nview, two_view
    from benchmark.reference.ops import image_ops

    saved = image_ops._fma_taps, two_view.generate_bundles, nview.generate_bundles
    image_ops._fma_taps = _taps_float32
    two_view.generate_bundles = _bundles_bfloat16(saved[1])
    nview.generate_bundles = _bundles_bfloat16(saved[2])
    try:
        yield
    finally:
        image_ops._fma_taps, two_view.generate_bundles, nview.generate_bundles = saved


def reversed_ba(job: compare.JobOutputs, state, images, ba_params, device) -> compare.JobOutputs:
    """``job`` with stage 5 done again by the program on the same filtered
    tracks in reversed order, its cloud put back in the tracks' order."""
    from ssrlcv_tpu_torch.ba.nview import bundle_adjust_nview
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages

    ms = state.matches
    rev = torch.flip(torch.arange(ms.capacity, device=device), [0])
    flipped = MatchSet(**{k: v[rev] for k, v in vars(ms).items()})
    cams = cameras_from_refimages(images, device)
    adjust = bundle_adjust if cams.num_cameras == 2 else bundle_adjust_nview
    r = adjust(flipped, cams, ba_params)
    live = ms.mask.cpu().numpy()
    return dataclasses.replace(
        job, ba_cameras=compare.cameras_arrays(r.cameras),
        ba_points=r.cloud.points[rev].detach().cpu().numpy()[live].astype(np.float32),
        ba_error=(float(r.initial_error), float(r.final_error)))


def diagnostics(prog: compare.JobOutputs, ref: compare.JobOutputs, ref_ba: dict) -> dict:
    """What the numbers rest on: feature, match and track counts, the
    errors (the job's, the reference's), and (m, quantiles 50/90/99/100) the adjusted points' gap to
    the reference's adjustment of the same tracks, and how far the job's
    and the reference's adjustments moved them."""
    out = {"features": [[len(a["sigma"]), len(b["sigma"])]
                        for a, b in zip(prog.features, ref.features)],
           "initial": [len(prog.initial), len(ref.initial)],
           "filtered": [len(prog.filtered), len(ref.filtered)],
           "ba_error": [list(prog.ba_error), list(ref_ba["error"])]}
    if len(prog.ba_points):
        q = [50, 90, 99, 100]
        for name, a, b in (("ba_gap_m", prog.ba_points, ref_ba["points"]),
                           ("ba_moved_m", prog.ba_points, ref_ba["start"]),
                           ("ref_moved_m", ref_ba["points"], ref_ba["start"])):
            out[name] = np.percentile(compare._gap_m(a, b), q).tolist()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--control-seeds", default="", help="comma-separated run seeds")
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    from benchmark.reference import config as reference_config
    from benchmark.reference.pipeline import reconstruct
    from ssrlcv_tpu_torch.logging import logger

    cell = H.load_json("workloads", f"{args.workload}.json")
    cfg = H.load_json("configs", f"{cell['config']}.json")
    traffic = H.load_json("traffic", f"{cell['traffic']}.json")
    dev = torch.device("cuda:0")
    run_dir = tempfile.mkdtemp(prefix="ssrlcv-calibrate-")
    logger.close()
    logger.log_dir, logger.path = run_dir, os.path.join(run_dir, "ssrlcv.log")
    program = H.Program(cfg, dev)
    rcfg = H.pipeline_config(reference_config, cfg)
    out_dir = os.path.join(run_dir, "out")
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    def scene_of(seed):
        return scene_mod.make_scene(H.pool_seeds(seed, traffic["pool"])[0], traffic["size"],
                                    cfg["views"], dev)

    lower, upper = {}, {}
    warm = False
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        sc = scene_of(seed)
        images = program.images(sc.views)
        if not warm:
            program.job(images, sc.seed.pixels, out_dir)
            warm = True
        t0 = time.perf_counter()
        state, seed_fs, _ = program.job(images, sc.seed.pixels, out_dir)
        t_job = time.perf_counter() - t0
        prog = compare.from_program(state, seed_fs, out_dir)
        del seed_fs
        t0 = time.perf_counter()
        ref = compare.from_reference(reconstruct(sc.views, sc.seed.pixels, rcfg, dev))
        ref_ba = compare.reference_ba(prog, sc.views, rcfg, dev)
        t_ref = time.perf_counter() - t0
        r = compare.readings(prog, ref, ref_ba, sc)
        emit({"side": "program", "seed": seed, "readings": r, "job_s": t_job, "ref_s": t_ref,
              **diagnostics(prog, ref, ref_ba)})
        rev = reversed_ba(prog, state, images, program.config.ba, dev)
        del state
        rev_ba = compare.reference_ba(rev, sc.views, rcfg, dev)
        r_rev = dict(compare.readings(rev, ref, rev_ba, sc))
        emit({"side": "program_reversed", "seed": seed, "readings": r_rev,
              **diagnostics(rev, ref, rev_ba)})
        for rr in (r, r_rev):
            for k, v in rr.items():
                if v is not None:
                    lower[k] = max(lower.get(k, -np.inf), v)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        sc = scene_of(seed)
        ref = compare.from_reference(reconstruct(sc.views, sc.seed.pixels, rcfg, dev))
        with control():
            ctl = compare.from_reference(reconstruct(sc.views, sc.seed.pixels, rcfg, dev))
        ref_ba = compare.reference_ba(ctl, sc.views, rcfg, dev)
        r = compare.readings(ctl, ref, ref_ba, sc)
        for k, v in r.items():
            if v is not None:
                upper[k] = min(upper.get(k, np.inf), v)
        emit({"side": "control", "seed": seed, "readings": r, **diagnostics(ctl, ref, ref_ba)})
    emit({"cell": args.workload, "lower": lower, "upper": upper,
          "device": torch.cuda.get_device_name(dev)})
    logger.close()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
