"""Seconds of N-view bundle adjustment a job: run_pipeline's stage 5 (CUDA
events), mean over the window's jobs; nothing with two views."""


def read(run):
    if run.views == 2 or not run.jobs:
        return None
    return sum(j.stage_s["bundle_adjust"] for j in run.jobs) / len(run.jobs)
