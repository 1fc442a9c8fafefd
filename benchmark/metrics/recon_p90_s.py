"""The 90th percentile of the latency of every job in the window (host
clock, from the job's start to its final synchronize; linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile([j.latency_s for j in run.jobs], 90)) if run.jobs else None
