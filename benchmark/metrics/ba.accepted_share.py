"""The share (%) of bundle adjustment's LM iterations that took a step, over
every job of the process: the program's counters
``do_bundle_adjust.accepted`` / ``do_bundle_adjust.iterations``.  An
iteration that takes no step changes nothing.  Nothing without the counters
or without a job."""


def read(run):
    if not run.jobs:
        return None
    from ssrlcv_tpu_torch.pipeline import stages

    iterations = getattr(stages.do_bundle_adjust, "iterations", 0)
    if not iterations:
        return None
    return 100.0 * stages.do_bundle_adjust.accepted / iterations
