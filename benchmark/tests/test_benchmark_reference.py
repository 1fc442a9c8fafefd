"""The reference against the program, the control and the faults, on the
CPU at a test's size (``cpu_run``): what decides ``correct`` has to pass a
sound run and fail each of them."""

import pytest
import torch

from benchmark import calibrate, compare, harness as H, scene as S

import cpu_run


def test_sound_run_agrees_with_the_reference_and_prints_the_result_line():
    rc, line, err = cpu_run.run()
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    for k in ("features_pct", "initial_pct", "filtered_pct", "ba_cloud_pct", "ba_stalled_pct"):
        assert line["checks"][k]["value"] == 0.0
    assert set(line["metrics"]) == {"recon_per_s", "recon_p90_s", "setup_s"}
    assert line["device"]["kind"] == "cpu"
    # each number compared, beside its limit, as the last lines on stderr
    assert [e.split(":")[0] for e in err[-len(line["checks"]):]] == [
        f"check {k}" for k in line["checks"]]
    assert set(line["checks"]) == set(compare.NUMBERS)


def test_sound_nview_run_agrees_with_the_reference():
    rc, line, _ = cpu_run.run("triple3v.1024", seed=7)
    assert rc == 0 and line["correct"] is True, line["checks"]


def test_control_is_not_correct():
    """The reference with the blur's taps in float32 (the control of
    ``calibrate.py``) in the program's place fails the cell's limits."""
    _, spec, cfg, _ = cpu_run.cell_files("pair2v.1024")
    from benchmark.reference import config as reference_config
    from benchmark.reference.pipeline import reconstruct

    rcfg = H.pipeline_config(reference_config, cfg)
    sc = S.make_scene(5, cpu_run.SIZE, 2, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = compare.from_reference(reconstruct(sc.views, sc.seed.pixels, rcfg, "cpu"))
        with calibrate.control():
            ctl = compare.from_reference(reconstruct(sc.views, sc.seed.pixels, rcfg, "cpu"))
        ref_ba = compare.reference_ba(ctl, sc.views, rcfg, "cpu")
    finally:
        torch.set_num_threads(threads)
    ok, checks = compare.judge(compare.worst([compare.readings(ctl, ref, ref_ba, sc)]),
                               dict(spec["limits"], **cfg["guarantees"]))
    assert not ok
    for k in ("features_pct", "ba_cloud_pct"):
        assert checks[k]["value"] > checks[k]["limit"], checks


def _ba_unchanged(monkeypatch):
    """Stage 5's step returns its state unchanged: the adjustment in the
    mode that applies no update."""
    from ssrlcv_tpu_torch.ba import two_view

    monkeypatch.setattr(two_view, "bundle_adjust", lambda m, c, p, mode="lm":
                        two_view.bundle_adjust_two_view(m, c, iterations=p.iterations,
                                                        mode="reference"))
    return "ba_stalled_pct"


def _half_the_matches(monkeypatch):
    """Half of the batch left out: every other match dropped where the
    match set is made, the rest carried on."""
    from ssrlcv_tpu_torch.matching import match

    made = match.matches_to_matchset

    def half(*a, **k):
        ms = made(*a, **k)
        keep = torch.arange(ms.capacity, device=ms.mask.device) % 2 == 0
        return ms.replace(mask=ms.mask & keep)

    monkeypatch.setattr(match, "matches_to_matchset", half)
    return "initial_pct"


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: a byte of every descriptor
    off by 8 in K2's epilogue."""
    from ssrlcv_tpu_torch.features import descriptor

    made = descriptor.descriptor_epilogue

    def altered(v, mask):
        d = made(v, mask).clone()
        d[:, 0] += 8
        return d

    monkeypatch.setattr(descriptor, "descriptor_epilogue", altered)
    return "features_pct"


# The fourth fault, the exchange between chips left out, the cells cannot
# have: each runs on one chip and exchanges nothing.
@pytest.mark.parametrize("fault", [_ba_unchanged, _half_the_matches, _answer_altered])
def test_fault_is_not_correct(monkeypatch, fault):
    number = fault(monkeypatch)
    rc, line, _ = cpu_run.run()
    assert rc == 0
    assert line["correct"] is False
    c = line["checks"][number]
    assert c["value"] > c["limit"], line["checks"]


def test_stalled_share_counts_the_jobs_whose_reference_steps():
    job = {k: 0.0 for k in compare.NUMBERS}
    per_job = [dict(job, ba_stalled_pct=100.0), dict(job), dict(job, ba_stalled_pct=None)]
    assert compare.worst(per_job)["ba_stalled_pct"] == 50.0
    assert compare.worst([dict(job, ba_stalled_pct=None)])["ba_stalled_pct"] == 0.0
