"""The reader of the scale space's launches (``features.scale_space.launches``)
on hand-built traces."""

import pytest

from benchmark import harness as H
from benchmark.trace import Trace


def _run(trace):
    rec = [H.JobRecord(latency_s=1.0, stage_s={}, seed_sift_s=0.0, scene=0)]
    return H.RunRecord(views=2, setup_s=1.0, window_s=1.0, jobs=rec, trace=trace)


def test_scale_space_launches_per_range():
    """Two SIFT calls (scale spaces 0-10 and 50-60): the launches inside
    them (3 + 2), over the two ranges; launches outside either do not
    count."""
    t = Trace(jobs=1, window=(0, 100), device_ops=[("k", 0, 5)],
              launches=[1, 4, 9, 10, 20, 50, 59, 60, 95],
              spans=[("job", 0, 100), ("stage.sift", 0, 30),
                     ("stage.sift.scale_space", 0, 10), ("stage.sift.detect", 10, 30),
                     ("stage.sift", 50, 70), ("stage.sift.scale_space", 50, 60)],
              k2_calls=[], k3_calls=[])
    assert H.load_reader("features.scale_space.launches")(_run(t)) == pytest.approx(5 / 2)


def test_scale_space_launches_without_the_range():
    """A program that opens no scale-space range, or an untraced run:
    nothing, and no exception."""
    t = Trace(jobs=1, window=(0, 100), device_ops=[("k", 0, 50)], launches=[10],
              spans=[("job", 0, 100), ("stage.sift", 0, 50)], k2_calls=[], k3_calls=[])
    read = H.load_reader("features.scale_space.launches")
    assert read(_run(t)) is None
    assert read(_run(None)) is None
