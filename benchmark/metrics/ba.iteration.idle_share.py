"""The share (%) of the union of the program's ``stage.ba.iteration``
ranges (each LM iteration of bundle adjustment) in the traced jobs in which
no operation ran on the card.  Nothing without such a range."""

from benchmark import spans


def read(run):
    return spans.idle_share(run.trace, "stage.ba.iteration")
