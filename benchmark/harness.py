"""One run of one cell: set-up, the measured window, the traced jobs, the
comparison with the reference, and the result line.

A job is what ``ssrlcv_tpu_torch/pipeline/sfm.py`` does once it has read its
files: SIFT of the seed image (``generate_features``), then ``run_pipeline``
on a fresh ``PipelineState`` of the views, which writes the initial,
filtered and adjusted clouds as PLY files and logs to the run directory
(under ``TMPDIR``).  The traffic is a closed loop with one job in flight, as
a ground or onboard pipeline works through a backlog of captures: the next
job starts when the last one has ended, each timed on the host clock to a
final ``synchronize``.  The jobs cycle through a pool of scenes rendered at
set-up from ``--seed``.  The window closes with the first job that ends
after ``--seconds``; every job in it counts, and its time is the window's.

A sample of the window's jobs, drawn from the seed as they run (reservoir
sampling), keeps its outputs; once the window has closed and the memory
peak has been read, the reference reconstructs their scenes and
``compare.py`` judges them.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

from benchmark import compare, counts, scene as scene_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ssrlcv_tpu")


@dataclasses.dataclass
class JobRecord:
    latency_s: float
    stage_s: dict          # run_pipeline's stage seconds (CUDA events)
    seed_sift_s: float     # the seed image's SIFT (CUDA events)
    scene: int             # index in the pool


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    views: int
    setup_s: float
    window_s: float
    jobs: list                       # [JobRecord] of the window
    trace: Optional[object] = None   # trace.Trace of a --trace 1 run


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``ssrlcv_tpu_torch`` is not ``ssrlcv_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pipeline_config(mod, cfg: dict, output_dir: str = "out"):
    """``mod.PipelineConfig`` (the program's or the reference's config
    module) of a configuration file."""
    sift = dict(cfg["sift"], kernel_size=tuple(cfg["sift"]["kernel_size"]))
    return mod.PipelineConfig(sift=mod.SIFTParams(**sift), match=mod.MatchParams(**cfg["match"]),
                              filter=mod.FilterParams(**cfg["filter"]),
                              ba=mod.BAParams(**cfg["ba"]), output_dir=output_dir)


def pool_seeds(seed: int, n: int) -> list:
    """The pool's scene seeds, drawn from the run's seed."""
    rng = np.random.default_rng(seed % (1 << 64))
    return [int(s) for s in rng.integers(0, 1 << 62, size=n)]


class Program:
    """The system under test: ``ssrlcv_tpu_torch`` driven as its command
    line drives it."""

    def __init__(self, cfg: dict, device):
        from ssrlcv_tpu_torch import config as program_config
        from ssrlcv_tpu_torch.features.sift import generate_features
        from ssrlcv_tpu_torch.io.refdata import RefImage
        from ssrlcv_tpu_torch.pipeline.stages import PipelineState, run_pipeline

        self.config = pipeline_config(program_config, cfg)
        self.device = device
        self._sift, self._state, self._run = generate_features, PipelineState, run_pipeline
        self._image = RefImage

    def images(self, views) -> list:
        """The views as the program's loader gives them."""
        return [self._image(**dataclasses.asdict(v)) for v in views]

    def job(self, images, seed_pixels, out_dir: str):
        """One reconstruction; returns (state, seed features, seed SIFT
        events), all queued work finished."""
        cfg = self.config.replace(output_dir=out_dir)
        clock = Clock(self.device)
        with torch.profiler.record_function("stage.seed_sift"):
            seed = self._sift(seed_pixels, cfg.sift, image_id=-1, device=self.device)
        clock.mark()
        state = self._state(config=cfg, images=images, device=self.device)
        state.seed_features = seed
        state = self._run(state)
        torch.cuda.synchronize(self.device)
        return state, seed, clock


class Clock:
    """Seconds from its making to ``mark()``: CUDA events on the current
    stream, read once the work is done."""

    def __init__(self, device):
        self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        self.ev[0].record()

    def mark(self):
        self.ev[1].record()

    def seconds(self) -> float:
        return self.ev[0].elapsed_time(self.ev[1]) / 1e3


def reservoir_slot(rng, i: int, k: int) -> Optional[int]:
    """Reservoir sampling of ``k`` jobs: the slot job ``i`` takes, or None."""
    if i < k:
        return i
    j = int(rng.integers(0, i + 1))
    return j if j < k else None


def run_window(program, pool, seconds: float, keep: int, rng, run_dir: str):
    """The closed loop: jobs back to back, cycling through the pool, until
    one ends after ``seconds``.  Returns (records, failed, window seconds,
    kept {slot: (scene, state, seed, out_dir)})."""
    records, kept, failed = [], {}, 0
    t_start = time.perf_counter()
    i = 0
    while True:
        k = i % len(pool)
        slot = reservoir_slot(rng, i, keep) if keep else None
        out_dir = os.path.join(run_dir, f"keep{slot}" if slot is not None else "out")
        t0 = time.perf_counter()
        try:
            state, seed, clock = program.job(pool[k]["images"], pool[k]["seed"], out_dir)
        except Exception:  # a failed job counts against the run and the loop goes on
            traceback.print_exc()
            failed += 1
            state = None
        t1 = time.perf_counter()
        if state is not None:
            records.append(JobRecord(latency_s=t1 - t0, stage_s=dict(state.stage_seconds),
                                     seed_sift_s=clock.seconds(), scene=k))
            if slot is not None:
                kept[slot] = (k, state, seed, out_dir)
        i += 1
        if t1 - t_start >= seconds:
            return records, failed, t1 - t_start, kept


def run_traced(program, pool, jobs: int, start: int, run_dir: str):
    """``jobs`` more jobs under the profiler; returns (trace, seconds)."""
    from benchmark import trace as T

    rec = T.Recorder()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out_dir = os.path.join(run_dir, "out")
    with T.patched(rec), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(jobs):
            k = (start + i) % len(pool)
            with torch.profiler.record_function("job"):
                program.job(pool[k]["images"], pool[k]["seed"], out_dir)
        wall = time.perf_counter() - t0
    return T.collect(prof, rec, jobs), wall


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reference_readings(kept_out: dict, scenes: list, cfg: dict, device) -> list:
    """The numbers of every kept job against the reference's
    reconstruction of its scene (one reconstruction a scene)."""
    from benchmark.reference import config as reference_config
    from benchmark.reference.pipeline import reconstruct

    rcfg = pipeline_config(reference_config, cfg)
    per_scene, out = {}, []
    for k, prog in sorted(kept_out.values(), key=lambda kv: kv[0]):
        if k not in per_scene:
            sc = scenes[k]
            per_scene[k] = compare.from_reference(reconstruct(sc.views, sc.seed.pixels, rcfg,
                                                              device))
        ref_ba = compare.reference_ba(prog, scenes[k].views, rcfg, device)
        out.append(compare.readings(prog, per_scene[k], ref_ba, scenes[k]))
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell: workloads/<name>.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_process: float) -> int:
    parts = {"imports": time.perf_counter() - t_process}
    args = parse(argv)
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cell = load_json("workloads", f"{args.workload}.json")
        cfg = load_json("configs", f"{cell['config']}.json")
        traffic = load_json("traffic", f"{cell['traffic']}.json")
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: cannot read the cell {args.workload!r}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s), {have} available",
              file=sys.stderr)
        return 2
    try:
        import ssrlcv_tpu_torch  # noqa: F401  (the system under test, beside benchmark/)
    except ImportError as e:
        print(f"benchmark: the program is missing from this checkout: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    parts["cuda"] = time.perf_counter() - t_process - sum(parts.values())
    run_dir = tempfile.mkdtemp(prefix="ssrlcv-bench-")
    from ssrlcv_tpu_torch.logging import logger

    logger.close()
    logger.log_dir, logger.path = run_dir, os.path.join(run_dir, "ssrlcv.log")
    try:
        program = Program(cfg, dev)
        parts["program"] = time.perf_counter() - t_process - sum(parts.values())
        return _run(args, bench, cell, cfg, traffic, program, dev, run_dir, t_process, parts)
    finally:
        logger.close()
        shutil.rmtree(run_dir, ignore_errors=True)


def _run(args, bench, cell, cfg, traffic, program, dev, run_dir, t_process, parts) -> int:
    """The run from set-up's pool on; ``parts`` holds the seconds of
    set-up's parts so far, which it completes and prints."""
    n_views = cfg["views"]
    seeds = pool_seeds(args.seed, traffic["pool"])
    scenes = [scene_mod.make_scene(s, traffic["size"], n_views, dev) for s in seeds]
    pool = [{"images": program.images(sc.views), "seed": sc.seed.pixels} for sc in scenes]
    torch.cuda.synchronize(dev)
    parts["pool"] = time.perf_counter() - t_process - sum(parts.values())
    program.job(pool[0]["images"], pool[0]["seed"], os.path.join(run_dir, "out"))  # warm-up
    setup_s = time.perf_counter() - t_process
    parts["warm_job"] = setup_s - sum(parts.values())
    print("set-up parts (s): " + json.dumps(parts), file=sys.stderr, flush=True)

    rng = np.random.default_rng([args.seed % (1 << 64), 1])
    cpu0 = time.process_time()
    records, failed, window_s, kept = run_window(program, pool, args.seconds,
                                                 traffic["compare_jobs"], rng, run_dir)
    print(f"window: {len(records)} jobs in {window_s!r} s, the process's CPU seconds "
          f"{time.process_time() - cpu0!r}", file=sys.stderr, flush=True)
    memory_peak = torch.cuda.max_memory_allocated(dev)
    kept_out = {slot: (k, compare.from_program(state, seed, d))
                for slot, (k, state, seed, d) in kept.items()}
    del kept
    gc.collect()
    print("card: " + json.dumps(counts.device_record()), file=sys.stderr, flush=True)

    run = RunRecord(views=n_views, setup_s=setup_s, window_s=window_s, jobs=records)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell["chips"],
              "memory_peak_bytes": int(memory_peak)}
    if args.trace:
        run.trace, wall = run_traced(program, pool, traffic["trace_jobs"], len(records) + 1,
                                     run_dir)
        traced, untraced = run.trace.jobs / wall, len(records) / window_s
        print(json.dumps({"tracing_overhead": {"recon_per_s_traced": traced,
                                               "recon_per_s_untraced": untraced,
                                               "difference": traced - untraced}}), flush=True)
        device.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = run.trace.breakdown() if args.trace else None
    run.trace = None
    gc.collect()
    torch.cuda.empty_cache()

    per_job = reference_readings(kept_out, scenes, cfg, dev) if kept_out else []
    limits = dict(cell["limits"], **cfg["guarantees"])
    correct, checks = compare.judge(compare.worst(per_job) if per_job else {}, limits)
    correct = correct and failed == 0 and bool(records)

    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of the JAX package loaded in this process: {found}",
              file=sys.stderr)
        return 3
    out = {"correct": correct, "attempted": len(records) + failed, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    lat = {}
    for j in records:
        lat.setdefault(j.scene, []).append(j.latency_s)
    print("jobs by scene (count, mean s): " + json.dumps(
        {k: [len(v), sum(v) / len(v)] for k, v in sorted(lat.items())}), file=sys.stderr)
    print("job latencies (ms): " + " ".join(f"{1e3 * j.latency_s:.0f}" for j in records),
          file=sys.stderr)
    print(f"compared {len(per_job)} job(s) with the reference", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
