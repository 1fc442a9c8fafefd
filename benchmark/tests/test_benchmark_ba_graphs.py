"""The reader of BA's CUDA-graph share (``ba.graph_share``) on the
program's counters."""

import pytest

from benchmark import harness as H


def _run(jobs=1):
    rec = [H.JobRecord(latency_s=1.0, stage_s={}, seed_sift_s=0.0, scene=0)] * jobs
    return H.RunRecord(views=2, setup_s=1.0, window_s=1.0, jobs=rec)


def test_graph_share_reads_the_programs_counters(monkeypatch):
    from ssrlcv_tpu_torch.pipeline import stages

    monkeypatch.setattr(stages.do_bundle_adjust, "iterations", 40, raising=False)
    monkeypatch.setattr(stages.do_bundle_adjust, "graphed_iterations", 30, raising=False)
    read = H.load_reader("ba.graph_share")
    assert read(_run()) == pytest.approx(75.0)
    assert read(_run(jobs=0)) is None
    monkeypatch.setattr(stages.do_bundle_adjust, "graphed_iterations", 0)
    assert read(_run()) == 0.0  # every iteration eager: the CPU's path
    monkeypatch.setattr(stages.do_bundle_adjust, "iterations", 0)
    assert read(_run()) is None


def test_graph_share_without_the_counter(monkeypatch):
    """A program without the counter (the parent of the change that added
    it): nothing, and no exception."""
    from ssrlcv_tpu_torch.pipeline import stages

    monkeypatch.setattr(stages.do_bundle_adjust, "iterations", 40, raising=False)
    if hasattr(stages.do_bundle_adjust, "graphed_iterations"):
        monkeypatch.delattr(stages.do_bundle_adjust, "graphed_iterations")
    assert H.load_reader("ba.graph_share")(_run()) is None
