"""The share (%) of the union of the program's ``stage.sift.scale_space``
ranges (the scale space of each SIFT call, the seed image's too) in the
traced jobs in which no operation ran on the card: near 0 when the scale
space is device time, near 100 when it is the host's launches.  Nothing
without such a range."""

from benchmark import spans


def read(run):
    return spans.idle_share(run.trace, "stage.sift.scale_space")
