"""The share (%) of 2-view bundle adjustment calls whose objective reached
the cameras by view column, over every job of the process: the program's
counters ``do_bundle_adjust.column_cameras`` /
``do_bundle_adjust.two_view_calls``.  Nothing without the counters, without
a job or without a 2-view call."""


def read(run):
    if not run.jobs:
        return None
    from ssrlcv_tpu_torch.pipeline import stages

    calls = getattr(stages.do_bundle_adjust, "two_view_calls", 0)
    if not calls:
        return None
    return 100.0 * stages.do_bundle_adjust.column_cameras / calls
