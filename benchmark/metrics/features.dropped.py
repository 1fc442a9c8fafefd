"""Features dropped a SIFT call, over every call of the process: the
program's counters ``generate_features.dropped / .calls`` (valid features
cut at ``max_keypoints`` plus extrema cut at an octave's capacity).  0
wherever nothing the reference keeps is dropped.  Nothing without the
counters or without a job."""


def read(run):
    if not run.jobs:
        return None
    from ssrlcv_tpu_torch.features import sift

    calls = getattr(sift.generate_features, "calls", 0)
    if not calls:
        return None
    return sift.generate_features.dropped / calls
