"""The share (%) of the union of the program's ``stage.sift`` ranges (each
SIFT call, the seed image's too) in the traced jobs in which no operation
ran on the card.  Nothing without such a range."""

from benchmark import spans


def read(run):
    return spans.idle_share(run.trace, "stage.sift")
