"""The traced jobs of a ``--trace 1`` run, and what the per-layer readers
take from them.

A fixed number of jobs run under ``torch.profiler`` after the measured
window.  The program's own stage spans (the ``log_state`` markers that
``run_pipeline`` sets at each stage's begin and end) become profiler
ranges named ``stage.<name>``; the benchmark adds ``job`` around each job
and ``stage.seed_sift`` around its seed SIFT.  The calls of K2
(``descriptor_histograms``) and K3 (``best_target``) are recorded with
their inputs, whose work ``counts.py`` counts afterwards.  Everything is
read from the raw profiler events: device operations and their intervals,
the host's kernel launches, and the ranges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

import torch

K2_KERNEL = re.compile(r"\bdesc_hist_kernel\b")
K3_KERNEL = re.compile(r"\bmatch_(extent|keys|layout|best_kernel|best_finish)\b")
LAUNCH = re.compile(r"^cu(da)?LaunchKernel")


@dataclasses.dataclass
class Trace:
    jobs: int                    # traced jobs
    window: tuple                # (start_ns, end_ns): first job start, last job end
    device_ops: list             # [(name, start_ns, end_ns)] on the card, in the window
    launches: list               # [start_ns] of the host's kernel launch calls
    spans: list                  # [(name, start_ns, end_ns)] of the ranges
    k2_calls: list               # [dict] the inputs of each K2 call
    k3_calls: list               # [dict] the inputs of each K3 call

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in the window in which some operation ran on the card."""
        total, end = 0, None
        lo, hi = self.window
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9

    def kernel_s(self, pattern) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        return sum(b - a for n, a, b in self.device_ops if pattern.search(n)) / 1e9

    def stage_at(self, t_ns: int) -> str:
        """The innermost stage range around host time ``t_ns`` ("job" between
        stages, "host" outside every job)."""
        best, width = "host", None
        for n, a, b in self.spans:
            if a <= t_ns < b and (width is None or b - a < width):
                best, width = n, b - a
        return best

    def launches_in(self, stage: str) -> int:
        """Kernel launches the host made inside the ranges named ``stage``."""
        ranges = [(a, b) for n, a, b in self.spans if n == stage]
        return sum(1 for t in self.launches if any(a <= t < b for a, b in ranges))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the stage the host was in when each began."""
        per_op = {}
        for n, a, b in self.device_ops:
            per_op[n] = per_op.get(n, 0) + (b - a)
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
        gaps, end = [], self.window[0]
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            if a > end:
                gaps.append((a - end, end))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((self.window[1] - end, end))
        per_stage = {}
        for width, start in gaps:
            name = self.stage_at(start)
            per_stage[name] = per_stage.get(name, 0) + width
        idle = sorted(per_stage.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[_short(n), s / 1e9] for n, s in ops],
                "idle_gaps": [[n, s / 1e9] for n, s in idle]}


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


class Recorder:
    """Records the inputs of K2 and K3 calls and turns the program's stage
    markers into profiler ranges, while ``active``."""

    def __init__(self):
        self.k2, self.k3 = [], []
        self._open = {}

    def log_state(self, original):
        def wrapped(state: str):
            original(state)
            parts = state.split(":")
            if len(parts) == 3 and parts[0].startswith("stage"):
                name = f"stage.{parts[1]}"
                if parts[2] == "begin":
                    rf = torch.profiler.record_function(name)
                    rf.__enter__()
                    self._open[name] = rf
                elif parts[2] == "end" and name in self._open:
                    self._open.pop(name).__exit__(None, None, None)
        return wrapped

    def k2_call(self, original):
        def wrapped(gx, gy, loc, theta, sigma, pixel_width, lambda_d, w_max):
            out = original(gx, gy, loc, theta, sigma, pixel_width, lambda_d, w_max)
            self.k2.append({"tensors": (gx, gy, loc, theta, sigma, out), "theta": theta,
                            "sigma": sigma, "pw": pixel_width, "lam": lambda_d, "w_max": w_max})
            return out
        return wrapped

    def k3_call(self, original):
        def wrapped(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid, q_valid=None):
            idx, dist = original(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid, q_valid)
            self.k3.append({"tensors": (q_desc, t_desc, t_loc, p1, p2, t_valid, idx, dist)
                            + ((q_valid,) if q_valid is not None else ()),
                            "q_mask": q_valid if q_valid is not None else
                            torch.ones(q_desc.shape[0], dtype=torch.bool, device=q_desc.device),
                            "t_valid": t_valid, "p1": p1, "p2": p2, "t_loc": t_loc,
                            "eps": epsilon})
            return idx, dist
        return wrapped


@contextlib.contextmanager
def patched(recorder: Recorder):
    """Route the program's stage markers and its K2 / K3 entry points
    through ``recorder`` for the traced jobs, and restore them after."""
    from ssrlcv_tpu_torch.features import descriptor
    from ssrlcv_tpu_torch.logging import logger
    from ssrlcv_tpu_torch.matching import match

    saved = (descriptor.descriptor_histograms, match.best_target)
    logger.log_state = recorder.log_state(type(logger).log_state.__get__(logger))
    descriptor.descriptor_histograms = recorder.k2_call(saved[0])
    match.best_target = recorder.k3_call(saved[1])
    try:
        yield
    finally:
        del logger.log_state
        descriptor.descriptor_histograms, match.best_target = saved


def collect(prof, recorder: Recorder, jobs: int) -> Trace:
    """The raw events of ``prof`` as a Trace."""
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, launches, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if e.name() != "job" and not e.name().startswith("stage."):  # not a range's shadow
                device_ops.append((e.name(), a, b))
        elif LAUNCH.search(e.name()):
            launches.append(a)
        elif e.name() == "job" or e.name().startswith("stage."):
            spans.append((e.name(), a, b))
    job_spans = [(a, b) for n, a, b in spans if n == "job"]
    if not job_spans:
        raise RuntimeError("the trace holds no job range")
    window = (min(a for a, _ in job_spans), max(b for _, b in job_spans))
    device_ops = [op for op in device_ops if op[2] > window[0] and op[1] < window[1]]
    return Trace(jobs=jobs, window=window, device_ops=device_ops, launches=launches,
                 spans=spans, k2_calls=recorder.k2, k3_calls=recorder.k3)
