"""The readers of SIFT detection's launches and idle share
(``features.detect.launches``, ``features.detect.idle_share``) on
hand-built traces."""

import pytest

from benchmark import harness as H
from benchmark.trace import Trace


def _run(trace):
    rec = [H.JobRecord(latency_s=1.0, stage_s={}, seed_sift_s=0.0, scene=0)]
    return H.RunRecord(views=2, setup_s=1.0, window_s=1.0, jobs=rec, trace=trace)


def _trace(device_ops, launches):
    """One SIFT call with two octaves: detection ranges 10-20 and 40-60,
    description between them."""
    return Trace(jobs=1, window=(0, 100), device_ops=device_ops, launches=launches,
                 spans=[("job", 0, 100), ("stage.sift", 0, 70),
                        ("stage.sift.scale_space", 0, 10), ("stage.sift.detect", 10, 20),
                        ("stage.sift.describe", 20, 40), ("stage.sift.detect", 40, 60),
                        ("stage.sift.describe", 60, 70)],
                 k2_calls=[], k3_calls=[])


def test_detect_launches_per_octave():
    """Launches inside the two detection ranges (3 + 2), over the two
    ranges; launches at a range's end or outside both do not count."""
    t = _trace([("k", 0, 5)], launches=[5, 10, 12, 19, 20, 30, 45, 59, 60, 95])
    assert H.load_reader("features.detect.launches")(_run(t)) == pytest.approx(5 / 2)


def test_detect_idle_share_over_the_union_of_its_ranges():
    """The card busy 15-25 and 50-55: 5 + 5 of the detection ranges' 30
    units, so idle 2/3 of them."""
    t = _trace([("k", 15, 25), ("k", 50, 55), ("k", 80, 90)], launches=[])
    assert H.load_reader("features.detect.idle_share")(_run(t)) == pytest.approx(100.0 * 20 / 30)


@pytest.mark.parametrize("name", ["features.detect.launches", "features.detect.idle_share"])
def test_detect_readers_without_the_range(name):
    """A program that opens no detection range, or an untraced run:
    nothing, and no exception."""
    t = Trace(jobs=1, window=(0, 100), device_ops=[("k", 0, 50)], launches=[10],
              spans=[("job", 0, 100), ("stage.sift", 0, 50)], k2_calls=[], k3_calls=[])
    read = H.load_reader(name)
    assert read(_run(t)) is None
    assert read(_run(None)) is None
