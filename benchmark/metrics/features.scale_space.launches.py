"""Kernel launches of one SIFT scale space: the host's kernel launch calls
inside the program's ``stage.sift.scale_space`` ranges in the traced jobs
(torch.profiler), over the number of those ranges (one a SIFT call, the
seed image's too).  Nothing without such a range."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    n = len(spans.ranges(run.trace, "stage.sift.scale_space"))
    if not n:
        return None
    return run.trace.launches_in("stage.sift.scale_space") / n
