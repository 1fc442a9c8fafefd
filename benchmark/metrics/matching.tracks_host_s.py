"""Host seconds of N-view track building a traced job: the program's
``stage.tracks.build`` (the adjacency-chain assembly) and
``stage.tracks.assemble`` (the MatchSet made from the tracks) ranges, over
the traced jobs.  Nothing without such a range (two views)."""

from benchmark import spans

NAMES = ("stage.tracks.build", "stage.tracks.assemble")


def read(run):
    if run.trace is None or not any(spans.ranges(run.trace, n) for n in NAMES):
        return None
    return spans.seconds(run.trace, NAMES) / run.trace.jobs
