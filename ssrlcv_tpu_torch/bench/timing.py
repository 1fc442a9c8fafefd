"""Device time of a piece of GPU work from CUDA events."""

from __future__ import annotations

import torch

SLEEP_CYCLES = 200_000_000  # about 0.1 s of device clock


def cuda_ms(fn, reps: int, tries: int = 3) -> tuple[float, bool]:
    """(mean milliseconds of ``fn()`` over ``reps`` back-to-back runs after
    one warm-up, queued).

    The stream is first held by a device-side sleep, and the runs are
    queued behind it, so the timed window between the two events opens only
    once every launch is queued: with ``queued`` true the time is the
    device's alone, free of gaps in which the device waits for the host.
    The sleep is doubled up to ``tries`` times while the host falls behind;
    ``queued`` false means it never caught up (work that synchronises with
    the host, or a host slower than the device), and the time then includes
    host gaps."""
    fn()
    cycles = SLEEP_CYCLES
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            break
        cycles *= 2
    return start.elapsed_time(end) / reps, queued
