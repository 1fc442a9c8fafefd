"""The share (%) of N-view matching calls whose tracks the native builder
made, over the process: the program's counters
``generate_matches_exhaustive.native_calls`` / ``.calls``.  Nothing without
the counters, without a job or without such a call (two views)."""


def read(run):
    if not run.jobs:
        return None
    from ssrlcv_tpu_torch.matching import tracks

    calls = getattr(tracks.generate_matches_exhaustive, "calls", 0)
    native = getattr(tracks.generate_matches_exhaustive, "native_calls", None)
    if not calls or native is None:
        return None
    return 100.0 * native / calls
