"""The benchmark's files, the rules BENCHMARK.json keeps, and the harness's pieces that run
without a card."""

import ast
import json
import os
import re
import sys

import numpy as np
import pytest

from benchmark import harness as H
from benchmark.trace import Trace

BENCH_DIR = H.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_its_rules():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(H.ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for x in b[g]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    assert len({x["name"] for x in b["end_to_end"] + b["per_layer"]}) == len(
        b["end_to_end"]) + len(b["per_layer"])
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(H.ROOT, c["file"]))
        assert _one_line(c["source"]) and c["source"].startswith("https://") and _one_line(c["why"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1 and _one_line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    b = _bench()
    for w in b["workloads"]:
        e2e = H.cell_metrics(b, w["name"], trace=False)
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert H.cell_metrics(b, w["name"], trace=True)


def test_files_are_found_by_name_and_parse():
    b = _bench()
    for w in b["workloads"]:
        spec = H.load_json("workloads", f"{w['name']}.json")
        assert {k: spec[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        traffic = H.load_json("traffic", f"{spec['traffic']}.json")
        assert traffic["pool"] >= 1
        assert set(spec["limits"]) | set(H.load_json("configs", f"{spec['config']}.json")
                                         ["guarantees"]) == set(H.compare.NUMBERS)
    for c in b["configs"]:
        cfg = H.load_json("configs", f"{c['name']}.json")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        from ssrlcv_tpu_torch import config as program_config
        from benchmark.reference import config as reference_config

        for mod in (program_config, reference_config):
            H.pipeline_config(mod, cfg)
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(H.load_reader(m["name"]))
    for root, _, files in os.walk(BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), H.ROOT)
            if "__pycache__" not in rel:
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(top):
    for root, _, files in os.walk(top):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_program():
    for path in _py_files(BENCH_DIR):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "ssrlcv_tpu"}, path
        if "/tests/" not in path:  # the yardstick uses its own copies
            assert "chip_smoke" not in tops, path
            assert not any(m.startswith("ssrlcv_tpu_torch.bench") for m in _imports(path)), path
    for path in _py_files(os.path.join(BENCH_DIR, "reference")):
        assert "ssrlcv_tpu_torch" not in {m.split(".")[0] for m in _imports(path)}, path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ssrlcv_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.sub", object())
    assert H.forbidden_modules() == [m for m in ("jax", "ssrlcv_tpu") if m in sys.modules]
    monkeypatch.setitem(sys.modules, "ssrlcv_tpu.x", object())
    assert "ssrlcv_tpu" in H.forbidden_modules()


def test_reservoir_keeps_k_jobs_drawn_from_the_seed():
    def slots(seed, n=40, k=2):
        rng = np.random.default_rng([seed, 1])
        kept = {}
        for i in range(n):
            s = H.reservoir_slot(rng, i, k)
            if s is not None:
                kept[s] = i
        return kept

    assert slots(5) == slots(5) and len(slots(5)) == 2
    late = sum(max(slots(s).values()) >= 20 for s in range(200))
    assert 100 < late < 200  # later jobs are drawn too


def test_pool_seeds_take_any_large_seed():
    assert H.pool_seeds(2**31 + 7, 4) == H.pool_seeds(2**31 + 7, 4)
    assert len(set(H.pool_seeds(2**40, 4))) == 4
    assert H.pool_seeds(1, 4) != H.pool_seeds(2, 4)


def _run(views=2, jobs=(), trace=None):
    rec = [H.JobRecord(latency_s=l, stage_s={"features": 0.2, "matching": 0.01,
                                             "triangulation": 0.004, "filtering": 0.006,
                                             "bundle_adjust": 0.4},
                       seed_sift_s=0.1, scene=0) for l in jobs]
    return H.RunRecord(views=views, setup_s=12.0, window_s=sum(jobs) or 1.0, jobs=rec,
                       trace=trace)


def test_readers_return_nothing_without_something_to_read():
    b = _bench()
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] != "setup_s":
            assert H.load_reader(m["name"])(_run()) is None, m["name"]
    run = _run(views=3, jobs=(1.0, 1.2))
    assert H.load_reader("ba.two_view.s")(run) is None
    assert H.load_reader("ba.nview.s")(run) == pytest.approx(0.4)
    assert H.load_reader("recon_per_s")(run) == pytest.approx(2 / 2.2)
    assert H.load_reader("pipeline.other_s")(run) == pytest.approx(1.1 - 0.62 - 0.1)
    for name in ("K2_roofline", "K3_roofline", "device.idle_share", "ba.two_view.launches"):
        assert H.load_reader(name)(run) is None


def test_trace_busy_gaps_and_launches():
    t = Trace(jobs=1, window=(0, 100), device_ops=[("a", 10, 30), ("b", 20, 40), ("a", 60, 70)],
              launches=[15, 55, 65, 90], spans=[("job", 0, 100), ("stage.features", 0, 50),
                                                ("stage.bundle_adjust", 50, 100)],
              k2_calls=[], k3_calls=[])
    assert t.busy_s() == pytest.approx(40e-9)
    assert t.launches_in("stage.bundle_adjust") == 3
    br = t.breakdown()
    assert br["device_ops"][0] == ["a", pytest.approx(30e-9)]
    assert dict(br["idle_gaps"]) == {"stage.features": pytest.approx(10e-9 + 20e-9),
                                     "stage.bundle_adjust": pytest.approx(30e-9)}
    assert H.load_reader("device.idle_share")(_run(trace=t)) == pytest.approx(60.0)
