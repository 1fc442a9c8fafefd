"""Reconstructions completed per second: the window's jobs over the
window's seconds (host clock, each job to a final synchronize)."""


def read(run):
    return len(run.jobs) / run.window_s if run.jobs else None
