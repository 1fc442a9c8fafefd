"""Kernel launches of 2-view bundle adjustment a job: the host's kernel
launch calls inside stage 5's range in the traced jobs (torch.profiler),
over the traced jobs; nothing with more views or without a trace."""


def read(run):
    if run.views != 2 or run.trace is None:
        return None
    return run.trace.launches_in("stage.bundle_adjust") / run.trace.jobs
