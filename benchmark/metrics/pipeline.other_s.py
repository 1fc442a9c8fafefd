"""Seconds a job spends outside its stages and its seed SIFT, mean over
the window's jobs: the job's wall time less run_pipeline's stage seconds
(CUDA events) and the seed SIFT's (CUDA events); PLY and log writes, host
work between stages, the final synchronize."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.latency_s - sum(j.stage_s.values()) - j.seed_sift_s
               for j in run.jobs) / len(run.jobs)
