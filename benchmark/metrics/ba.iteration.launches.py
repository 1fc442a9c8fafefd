"""Kernel launches of one iteration of bundle adjustment's LM loop: the
host's kernel launch calls inside the program's ``stage.ba.iteration``
ranges in the traced jobs (torch.profiler), over the number of those
ranges; 2-view and N-view alike.  Nothing without such a range."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    n = len(spans.ranges(run.trace, "stage.ba.iteration"))
    if not n:
        return None
    return run.trace.launches_in("stage.ba.iteration") / n
