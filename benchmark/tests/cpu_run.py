"""A run of the harness on the CPU at a size a test run holds: the whole
run but the look for a chip (``harness._run``), on 128^2 scenes with a
feature capacity of 4096, one thread (the CPU's multi-threaded sums change
bundle adjustment's path from call to call), one job in the window.  The
CUDA calls the harness makes are stood in for by the host: events by the
host clock, the card's name and record by "cpu"."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import tempfile
import time
from unittest import mock

import torch

from benchmark import harness as H

SIZE = 128
CAPACITY = 4096


def cell_files(cell: str):
    bench = H.load_json("..", "BENCHMARK.json")
    spec = H.load_json("workloads", f"{cell}.json")
    cfg = H.load_json("configs", f"{spec['config']}.json")
    cfg["sift"]["max_keypoints"] = CAPACITY
    traffic = dict(H.load_json("traffic", f"{spec['traffic']}.json"), size=SIZE, pool=2)
    return bench, spec, cfg, traffic


class HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def on_the_host():
    """The harness's CUDA calls, stood in for on the host."""
    stack = contextlib.ExitStack()
    for name, value in (("Event", HostEvent), ("synchronize", lambda *a, **k: None),
                        ("max_memory_allocated", lambda *a, **k: 0),
                        ("get_device_name", lambda *a, **k: "cpu"),
                        ("empty_cache", lambda: None)):
        stack.enter_context(mock.patch.object(torch.cuda, name, value))
    stack.enter_context(mock.patch.object(H.counts, "device_record", lambda: {"name": "cpu"}))
    return stack


def run(cell: str = "pair2v.1024", seed: int = 2**31 + 11):
    """(exit code, the last line as a dict, the lines of standard error)."""
    bench, spec, cfg, traffic = cell_files(cell)
    dev = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    run_dir = tempfile.mkdtemp(prefix="ssrlcv-bench-test-")
    from ssrlcv_tpu_torch.logging import logger

    logger.close()
    saved = logger.log_dir, logger.path
    logger.log_dir, logger.path = run_dir, f"{run_dir}/ssrlcv.log"
    out, err = io.StringIO(), io.StringIO()
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.0, trace=0)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), on_the_host():
            rc = H._run(args, bench, spec, cfg, traffic, H.Program(cfg, dev), dev, run_dir,
                        time.perf_counter(), {})
    finally:
        torch.set_num_threads(threads)
        logger.close()
        logger.log_dir, logger.path = saved
        shutil.rmtree(run_dir, ignore_errors=True)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue().splitlines()
