"""Seconds of triangulation and filtering a job: run_pipeline's stages 3
and 4 (CUDA events), mean over the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.stage_s["triangulation"] + j.stage_s["filtering"]
               for j in run.jobs) / len(run.jobs)
