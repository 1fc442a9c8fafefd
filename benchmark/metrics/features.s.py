"""Seconds of SIFT a job: run_pipeline's stage 0 (SIFT of every view) plus
the seed image's SIFT, both from CUDA events, mean over the window's
jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.stage_s["features"] + j.seed_sift_s for j in run.jobs) / len(run.jobs)
