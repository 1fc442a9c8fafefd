"""The share (%) of the union of the program's ``stage.sift.detect`` ranges
(each octave's detection in each SIFT call, the seed image's too) in the
traced jobs in which no operation ran on the card: near 100 when detection
is the host's launches and waits, lower as the card does its work.  Nothing
without such a range."""

from benchmark import spans


def read(run):
    return spans.idle_share(run.trace, "stage.sift.detect")
