"""The reader of the 2-view objective's camera path (``ba.column_share``)
on the program's counters."""

import pytest

from benchmark import harness as H


def _run(jobs=1):
    rec = [H.JobRecord(latency_s=1.0, stage_s={}, seed_sift_s=0.0, scene=0)] * jobs
    return H.RunRecord(views=2, setup_s=1.0, window_s=1.0, jobs=rec)


def test_column_share_reads_the_programs_counters(monkeypatch):
    from ssrlcv_tpu_torch.pipeline import stages

    monkeypatch.setattr(stages.do_bundle_adjust, "two_view_calls", 8, raising=False)
    monkeypatch.setattr(stages.do_bundle_adjust, "column_cameras", 6, raising=False)
    read = H.load_reader("ba.column_share")
    assert read(_run()) == pytest.approx(75.0)
    assert read(_run(jobs=0)) is None
    monkeypatch.setattr(stages.do_bundle_adjust, "two_view_calls", 0)
    assert read(_run()) is None  # no 2-view call: the N-view path


def test_column_share_without_the_counters(monkeypatch):
    """A program without the counters: nothing, and no exception."""
    from ssrlcv_tpu_torch.pipeline import stages

    for name in ("two_view_calls", "column_cameras"):
        if hasattr(stages.do_bundle_adjust, name):
            monkeypatch.delattr(stages.do_bundle_adjust, name)
    assert H.load_reader("ba.column_share")(_run()) is None
