"""The reader of the native track builder's share
(``matching.tracks_native_share``) on the program's counters."""

import pytest

from benchmark import harness as H


def _run(jobs=1):
    rec = [H.JobRecord(latency_s=1.0, stage_s={}, seed_sift_s=0.0, scene=0)] * jobs
    return H.RunRecord(views=3, setup_s=1.0, window_s=1.0, jobs=rec)


def test_tracks_native_share_reads_the_programs_counters(monkeypatch):
    from ssrlcv_tpu_torch.matching import tracks

    gme = tracks.generate_matches_exhaustive
    monkeypatch.setattr(gme, "calls", 8, raising=False)
    monkeypatch.setattr(gme, "native_calls", 8, raising=False)
    read = H.load_reader("matching.tracks_native_share")
    assert read(_run()) == pytest.approx(100.0)
    assert read(_run(jobs=0)) is None
    monkeypatch.setattr(gme, "native_calls", 2)
    assert read(_run()) == pytest.approx(25.0)
    monkeypatch.setattr(gme, "native_calls", 0)
    assert read(_run()) == 0.0  # every call built in Python: the CPU's path
    monkeypatch.setattr(gme, "calls", 0)
    assert read(_run()) is None  # two views: no N-view matching call


def test_tracks_native_share_without_the_counters(monkeypatch):
    """A program without the counters (the parent of the change that added
    them): nothing, and no exception."""
    from ssrlcv_tpu_torch.matching import tracks

    gme = tracks.generate_matches_exhaustive
    for name in ("calls", "native_calls"):
        if hasattr(gme, name):
            monkeypatch.delattr(gme, name)
    assert H.load_reader("matching.tracks_native_share")(_run()) is None
    monkeypatch.setattr(gme, "calls", 3, raising=False)
    assert H.load_reader("matching.tracks_native_share")(_run()) is None
