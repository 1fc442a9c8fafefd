"""The readers of the program's own ranges (``benchmark/spans.py`` and the
metrics that use it) on hand-built traces, and ``trace.collect`` on a range
that leaves a shadow on the device's timeline."""

import types

import pytest
import torch

from benchmark import harness as H, spans, trace as T
from benchmark.trace import Trace


def _run(trace, views=2, jobs=(1.0,)):
    rec = [H.JobRecord(latency_s=x, stage_s={}, seed_sift_s=0.0, scene=0) for x in jobs]
    return H.RunRecord(views=views, setup_s=1.0, window_s=sum(jobs) or 1.0, jobs=rec,
                       trace=trace)


def _ba_trace():
    """One job: two LM iterations (10-30, 40-70) in stage 5 (5-95); the card
    busy 20-25 and 50-80; launches at 12, 22, 45, 50, 60 and 90; the scale
    space 0-5 with the card busy 0-4."""
    return Trace(jobs=1, window=(0, 100),
                 device_ops=[("k", 0, 4), ("k", 20, 25), ("k", 50, 80)],
                 launches=[12, 22, 45, 50, 60, 90],
                 spans=[("job", 0, 100), ("stage.sift.scale_space", 0, 5),
                        ("stage.bundle_adjust", 5, 95), ("stage.ba.iteration", 10, 30),
                        ("stage.ba.grad", 12, 20), ("stage.ba.iteration", 40, 70)],
                 k2_calls=[], k3_calls=[])


def test_union_and_overlap():
    assert spans.union([(5, 9), (0, 2), (1, 3), (9, 10), (4, 4)]) == [(0, 3), (5, 10)]
    assert spans.overlap_ns([(0, 3), (5, 10)], [(2, 6), (8, 20)]) == 1 + 1 + 2


def test_ba_iteration_readers():
    t = _ba_trace()
    assert H.load_reader("ba.iteration.launches")(_run(t)) == pytest.approx(5 / 2)
    # busy 5 of the first iteration's 20 and 20 of the second's 30
    assert H.load_reader("ba.iteration.idle_share")(_run(t)) == pytest.approx(
        100 * (1 - 25 / 50))
    assert H.load_reader("features.scale_space.idle_share")(_run(t)) == pytest.approx(20.0)


def test_tracks_host_seconds_per_job():
    t = Trace(jobs=2, window=(0, 1000), device_ops=[], launches=[],
              spans=[("job", 0, 500), ("stage.tracks.build", 100, 300),
                     ("stage.tracks.assemble", 300, 350), ("job", 500, 1000),
                     ("stage.tracks.build", 600, 700), ("stage.tracks.fetch", 700, 800)],
              k2_calls=[], k3_calls=[])
    assert H.load_reader("matching.tracks_host_s")(_run(t, views=3)) == pytest.approx(
        (250 + 100) / 2 / 1e9)
    assert H.load_reader("matching.tracks_host_s")(_run(_ba_trace())) is None


def test_readers_of_ranges_find_nothing_in_a_program_without_them():
    """A parent program that opens no such range: every new reader gives
    None and raises nothing."""
    t = Trace(jobs=1, window=(0, 100), device_ops=[("k", 0, 50)], launches=[10],
              spans=[("job", 0, 100), ("stage.bundle_adjust", 50, 100)],
              k2_calls=[], k3_calls=[])
    for name in ("ba.iteration.launches", "ba.iteration.idle_share",
                 "features.scale_space.idle_share", "matching.tracks_host_s"):
        assert H.load_reader(name)(_run(t)) is None, name
        assert H.load_reader(name)(_run(None)) is None, name


def test_accepted_share_reads_the_programs_counters(monkeypatch):
    from ssrlcv_tpu_torch.pipeline import stages

    monkeypatch.setattr(stages.do_bundle_adjust, "iterations", 40, raising=False)
    monkeypatch.setattr(stages.do_bundle_adjust, "accepted", 10, raising=False)
    read = H.load_reader("ba.accepted_share")
    assert read(_run(None)) == pytest.approx(25.0)
    assert read(_run(None, jobs=())) is None
    monkeypatch.delattr(stages.do_bundle_adjust, "iterations")
    monkeypatch.delattr(stages.do_bundle_adjust, "accepted")
    assert read(_run(None)) is None  # a program without the counters


class _Event:
    def __init__(self, name, a, b, cuda=False):
        self._n, self._a, self._b, self._cuda = name, a, b, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU


def _collect(events):
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return T.collect(prof, T.Recorder(), jobs=1)


def test_a_program_range_leaves_no_shadow_in_the_device_time():
    """A range the program opens is on the host and, as the profiler records
    it, on the device's timeline too, over the work launched in it.  Named
    stage.*, its shadow is no device operation: the idle share reads as
    without it, and the innermost range names the idle gap."""
    base = [_Event("job", 0, 100), _Event("stage.bundle_adjust", 0, 100),
            _Event("stage.ba.iteration", 10, 60), _Event("cudaLaunchKernel", 12, 13),
            _Event("k", 20, 30, cuda=True), _Event("k", 70, 80, cuda=True)]
    shadow = _Event("stage.ba.iteration", 20, 60, cuda=True)
    plain, shadowed = _collect(base), _collect(base + [shadow])
    idle = H.load_reader("device.idle_share")
    assert [n for n, _, _ in shadowed.device_ops] == ["k", "k"]
    assert idle(_run(shadowed)) == idle(_run(plain)) == pytest.approx(80.0)
    assert H.load_reader("ba.iteration.idle_share")(_run(shadowed)) == pytest.approx(80.0)
    # the gap 30-70 begins in the iteration
    assert dict(shadowed.breakdown()["idle_gaps"])["stage.ba.iteration"] == pytest.approx(40e-9)
    # a range under another name would count its shadow as device work
    stray = _collect(base + [_Event("ba.iteration", 20, 60, cuda=True)])
    assert idle(_run(stray)) < idle(_run(plain))
