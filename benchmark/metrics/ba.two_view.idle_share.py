"""The share (%) of the union of the ``stage.bundle_adjust`` ranges (stage
5) in the traced jobs in which no operation ran on the card: near 100 while
bundle adjustment is the host's launches, lower as its device work grows
with the points.  Nothing without such a range."""

from benchmark import spans


def read(run):
    return spans.idle_share(run.trace, "stage.bundle_adjust")
