"""Seconds of matching a job: run_pipeline's stage 2 (CUDA events; with 3
views the pair sweep and build_tracks), mean over the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.stage_s["matching"] for j in run.jobs) / len(run.jobs)
