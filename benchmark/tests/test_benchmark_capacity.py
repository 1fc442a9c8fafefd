"""The 2048^2 deployment's files (``pair2v2048``, ``closed.2048``,
``pair2v.2048``) and the readers of the features' and 2-view BA's metrics
(``features.dropped``, ``features.idle_share``, ``ba.two_view.idle_share``)
on hand-built traces and counters."""

import pytest

from benchmark import harness as H
from benchmark.trace import Trace

DOC_KEYS = {"name", "source", "deployment", "max_keypoints_why", "assumed"}


def test_the_cell_and_its_files_load():
    bench = H.load_json("..", "BENCHMARK.json")
    cell = H.load_json("workloads", "pair2v.2048.json")
    cfg = H.load_json("configs", f"{cell['config']}.json")
    traffic = H.load_json("traffic", f"{cell['traffic']}.json")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("pair2v2048", "closed.2048", 1)
    assert cfg["sift"]["max_keypoints"] == 196608 and cfg["assumed"]["image_size"] == 2048
    assert traffic == dict(H.load_json("traffic", "closed.1024.json"), size=2048,
                           why=traffic["why"])
    assert [w for w in bench["workloads"] if w["name"] == "pair2v.2048"] == [
        {"name": "pair2v.2048", **{k: cell[k] for k in ("config", "traffic", "chips", "why")}}]
    assert [c["file"] for c in bench["configs"] if c["name"] == "pair2v2048"] == [
        "benchmark/configs/pair2v2048.json"]
    traced = {m["name"] for m in H.cell_metrics(bench, "pair2v.2048", True)}
    assert traced == {"features.dropped", "features.idle_share", "ba.two_view.idle_share"}
    for cell_name in ("pair2v.1024", "triple3v.1024"):
        traced = {m["name"] for m in H.cell_metrics(bench, cell_name, True)}
        assert {"features.dropped", "features.idle_share"} <= traced
    assert {m["name"] for m in H.cell_metrics(bench, "pair2v.2048", False)} == {
        "recon_per_s", "recon_p90_s", "setup_s"}


def test_the_configuration_is_pair2v_with_its_capacity_raised():
    """``pair2v2048`` is ``pair2v`` but for ``sift.max_keypoints`` and the
    keys that document it; its source names the part of the reference that
    keeps every feature, so it is not ``pair2v``'s."""
    base = H.load_json("configs", "pair2v.json")
    big = H.load_json("configs", "pair2v2048.json")
    assert big["source"] != base["source"] and "SIFT_FeatureFactory.cu" in big["source"]
    assert set(base) - DOC_KEYS == set(big) - DOC_KEYS
    for k in set(base) - DOC_KEYS - {"sift"}:
        assert base[k] == big[k], k
    assert dict(base["sift"], max_keypoints=196608) == big["sift"]
    assert {k: v for k, v in big["assumed"].items() if k not in ("image_size", "optics", "frame")} \
        == {k: v for k, v in base["assumed"].items() if k not in ("image_size", "optics")}


def _run(trace, jobs=1):
    rec = [H.JobRecord(latency_s=1.0, stage_s={}, seed_sift_s=0.0, scene=0)] * jobs
    return H.RunRecord(views=2, setup_s=1.0, window_s=1.0, jobs=rec, trace=trace)


def _trace():
    """Two SIFT calls (0-20, 50-60) and one stage 5 (70-100), the card busy
    over 5-15, 55-60 and 90-95."""
    return Trace(jobs=1, window=(0, 100), device_ops=[("k", 5, 15), ("k", 55, 60),
                                                      ("k", 90, 95)],
                 launches=[], spans=[("job", 0, 100), ("stage.sift", 0, 20),
                                     ("stage.sift.scale_space", 0, 10),
                                     ("stage.sift", 50, 60), ("stage.bundle_adjust", 70, 100),
                                     ("stage.bundle_adjust", 70, 100)],
                 k2_calls=[], k3_calls=[])


def test_idle_share_readers():
    """Idle over the union of each layer's ranges: SIFT 15 of 30, stage 5
    25 of 30 (its two nested ranges of one name count once)."""
    run = _run(_trace())
    assert H.load_reader("features.idle_share")(run) == pytest.approx(50.0)
    assert H.load_reader("ba.two_view.idle_share")(run) == pytest.approx(100.0 * 25 / 30)


def test_idle_share_readers_without_their_ranges():
    t = Trace(jobs=1, window=(0, 100), device_ops=[("k", 0, 50)], launches=[],
              spans=[("job", 0, 100)], k2_calls=[], k3_calls=[])
    for name in ("features.idle_share", "ba.two_view.idle_share"):
        assert H.load_reader(name)(_run(t)) is None
        assert H.load_reader(name)(_run(None)) is None


def test_dropped_reader(monkeypatch):
    """``generate_features.dropped / .calls``; nothing without the counters
    (a program that lacks them), without a call or without a job."""
    from ssrlcv_tpu_torch.features import sift

    read = H.load_reader("features.dropped")
    monkeypatch.setattr(sift.generate_features, "calls", 6, raising=False)
    monkeypatch.setattr(sift.generate_features, "dropped", 9, raising=False)
    assert read(_run(None)) == pytest.approx(1.5)
    assert read(_run(None, jobs=0)) is None
    monkeypatch.setattr(sift.generate_features, "dropped", 0)
    assert read(_run(None)) == 0.0
    monkeypatch.setattr(sift.generate_features, "calls", 0)
    assert read(_run(None)) is None
    monkeypatch.delattr(sift.generate_features, "calls")
    assert read(_run(None)) is None
