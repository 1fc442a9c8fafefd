"""Kernel launches of one octave's SIFT detection: the host's kernel launch
calls inside the program's ``stage.sift.detect`` ranges in the traced jobs
(torch.profiler), over the number of those ranges (one an octave of each
SIFT call, the seed image's too).  Nothing without such a range."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    n = len(spans.ranges(run.trace, "stage.sift.detect"))
    if not n:
        return None
    return run.trace.launches_in("stage.sift.detect") / n
