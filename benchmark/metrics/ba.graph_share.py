"""The share (%) of bundle adjustment's LM iterations whose gradient and
Hessian replayed CUDA graphs, over every job of the process: the program's
counters ``do_bundle_adjust.graphed_iterations`` /
``do_bundle_adjust.iterations``.  Nothing without the counters or without a
job."""


def read(run):
    if not run.jobs:
        return None
    from ssrlcv_tpu_torch.pipeline import stages

    iterations = getattr(stages.do_bundle_adjust, "iterations", 0)
    graphed = getattr(stages.do_bundle_adjust, "graphed_iterations", None)
    if not iterations or graphed is None:
        return None
    return 100.0 * graphed / iterations
