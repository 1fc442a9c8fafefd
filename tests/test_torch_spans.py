"""The port's spans (``Logger.span``) and bundle adjustment's count of the
steps it took, on the CPU.

A seeded synthetic 128x128 scene of two and of three views goes through
``run_pipeline`` twice: once with no profiler and no listener, once under
``torch.profiler`` (CPU activity) with a listener.  The outputs are equal
to the bit, and the traced run opens the spans of every layer, nested as
the layers are.
"""

import collections
import functools
import tempfile

import numpy as np
import pytest
import torch

ITERATIONS = 10  # BAParams().iterations, the pipeline's
COUNTERS = ("iterations", "graphed_iterations", "accepted", "two_view_calls", "column_cameras")


def _user_ranges(prof):
    """(name, start_ns, end_ns) of every range opened while ``prof``
    recorded, in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@functools.lru_cache(maxsize=None)
def _runs(views):
    """(views, scene, run with tracing off, run traced, the traced run's
    ranges, the listener's calls, the steps of ``do_bundle_adjust``'s
    counters in the untraced run, its log)."""
    from torch.profiler import ProfilerActivity, profile

    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.logging import logger
    from ssrlcv_tpu_torch.pipeline import stages as T
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=0, size=128, n_views=views)
    out_dir = tempfile.mkdtemp(prefix="ssrlcv-spans-")
    cfg = PipelineConfig(output_dir=out_dir).replace(
        match=MatchParams(epsilon=25.0, delta=5.0), sift=SIFTParams(max_keypoints=4096))

    def run():
        state = T.PipelineState(config=cfg, images=scene.images, device="cpu")
        state.seed_features = generate_features(scene.seed_image.pixels, cfg.sift, -1,
                                                device="cpu")
        return T.run_pipeline(state)

    # one thread: the CPU's multi-threaded sums change BA's path from call
    # to call
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    logger.close()
    saved = logger.log_dir, logger.path
    logger.log_dir, logger.path = out_dir, f"{out_dir}/ssrlcv.log"
    calls = []

    def listener(name, begin):
        calls.append((name, begin))

    try:
        before = {k: getattr(T.do_bundle_adjust, k) for k in COUNTERS}
        off = run()
        steps = {k: getattr(T.do_bundle_adjust, k) - before[k] for k in COUNTERS}
        logger.close()
        with open(logger.path) as f:
            log = f.read()
        logger.add_span_listener(listener)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = run()
    finally:
        logger.remove_span_listener(listener)
        torch.set_num_threads(threads)
        logger.close()
        logger.log_dir, logger.path = saved
    return views, scene, off, on, _user_ranges(prof), calls, steps, log


@pytest.fixture(scope="module", params=[2, 3], ids=["two_views", "three_views"])
def runs(request):
    return _runs(request.param)


def test_a_span_off_opens_no_range_and_calls_nothing(monkeypatch):
    """With no profiler and no listener a span is one shared context that
    does nothing: no range is made."""
    from ssrlcv_tpu_torch.logging import Logger

    def no_range(name):
        raise AssertionError(f"a range was opened: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    lg = Logger("unused")
    assert lg.span("a") is lg.span("b")
    with lg.span("a"), lg.span("b"):
        pass
    seen = []
    lg.add_span_listener(lambda name, begin: seen.append((name, begin)))
    with lg.span("a"):  # a listener alone opens no range either
        pass
    assert seen == [("stage.a", True), ("stage.a", False)]


def test_outputs_equal_with_tracing_on_and_off(runs):
    _, _, off, on, *_ = runs
    assert on.ba_error == off.ba_error
    for a, b in zip(off.features + [off.seed_features], on.features + [on.seed_features]):
        for name in ("loc", "sigma", "theta", "descriptors", "mask"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("kp_loc", "kp_parent", "num_views", "mask"):
        assert torch.equal(getattr(off.matches, name), getattr(on.matches, name)), name
    for name in ("points", "errors", "mask"):
        assert torch.equal(getattr(off.cloud, name), getattr(on.cloud, name)), name
    assert torch.equal(off.cameras.cam_pos, on.cameras.cam_pos)
    assert torch.equal(off.cameras.cam_rot, on.cameras.cam_rot)
    assert set(off.stage_seconds) == set(on.stage_seconds)


def test_every_layer_opens_its_spans(runs):
    """Every range the program opens is named stage.*: each stage, SIFT's
    parts, the matcher, the geometry, BA's parts and the PLY writes; the
    track builder's only with three views."""
    views, _, _, _, ranges, *_ = runs
    names = {n for n, _, _ in ranges}
    assert all(n.startswith("stage.") for n in names), names
    want = {"stage.features", "stage.pose", "stage.matching", "stage.triangulation",
            "stage.filtering", "stage.bundle_adjust",
            "stage.sift", "stage.sift.scale_space", "stage.sift.detect", "stage.sift.describe",
            "stage.sift.aggregate", "stage.match.seed_distances", "stage.match.double",
            "stage.geometry.triangulate", "stage.geometry.filter", "stage.io.write_ply",
            "stage.ba.setup", "stage.ba.iteration", "stage.ba.grad", "stage.ba.hessian",
            "stage.ba.solve", "stage.ba.objective", "stage.ba.final"}
    tracks = {"stage.tracks.sweep", "stage.tracks.fetch", "stage.tracks.build",
              "stage.tracks.assemble"}
    assert names == (want | tracks if views == 3 else want)
    count = {n: sum(1 for m, _, _ in ranges if m == n) for n in names}
    assert count["stage.sift"] == views + 1  # the seed image's too
    assert count["stage.io.write_ply"] == 3
    if views == 3:  # three pairs, each fetched once
        assert count["stage.tracks.fetch"] == count["stage.match.double"] == 3


def test_spans_nest_as_the_layers(runs):
    """Two ranges are disjoint or one holds the other; BA's iterations lie
    in stage 5, each with its parts, and SIFT's parts in its call."""
    views, _, _, _, ranges, *_ = runs
    for i, a in enumerate(ranges):
        for b in ranges[i + 1:]:
            if b[1] >= a[2]:
                break
            assert _inside(b, a), (a, b)

    def within(name, outer):
        return [r for r in ranges if r[0] == name and _inside(r, outer)]

    (ba,) = [r for r in ranges if r[0] == "stage.bundle_adjust"]
    iterations = within("stage.ba.iteration", ba)
    assert len(iterations) == ITERATIONS
    assert len(within("stage.ba.setup", ba)) == len(within("stage.ba.final", ba)) == 1
    for it in iterations:
        for part in ("stage.ba.grad", "stage.ba.hessian", "stage.ba.solve", "stage.ba.objective"):
            assert len(within(part, it)) == 1, part
    for sift in (r for r in ranges if r[0] == "stage.sift"):
        assert len(within("stage.sift.scale_space", sift)) == 1
        assert len(within("stage.sift.aggregate", sift)) == 1
        assert len(within("stage.sift.detect", sift)) == len(within("stage.sift.describe", sift))
    (matching,) = [r for r in ranges if r[0] == "stage.matching"]
    for r in ranges:
        if r[0].startswith("stage.tracks.") or r[0].startswith("stage.match."):
            assert _inside(r, matching), r
    assert views == 3 or not within("stage.tracks.build", matching)


def test_a_listener_sees_every_span_begin_and_end_in_nesting_order(runs):
    _, _, _, _, ranges, calls, *_ = runs
    open_ = []
    for name, begin in calls:
        if begin:
            open_.append(name)
        else:
            assert open_.pop() == name
    assert not open_
    assert collections.Counter(n for n, b in calls if b) == collections.Counter(
        n for n, _, _ in ranges)


def test_do_bundle_adjust_counts_and_logs_the_steps(runs):
    """The iterations run and the steps accepted go to
    ``do_bundle_adjust``'s counters and into its log row."""
    _, _, _, _, _, _, steps, log = runs
    iterations, accepted = steps["iterations"], steps["accepted"]
    assert iterations == ITERATIONS and 0 <= accepted <= ITERATIONS
    (row,) = [line for line in log.splitlines() if ",bundle adjust:" in line]
    assert row.endswith(f"({accepted} of {ITERATIONS} steps accepted)")


def test_do_bundle_adjust_counts_the_column_path(runs):
    """A run of two views counts one 2-view BA call, and its pair's
    tracks (one parent a view column) take the column path; a run of
    three views counts neither."""
    views, *_, steps, _ = runs
    two = int(views == 2)
    assert (steps["two_view_calls"], steps["column_cameras"]) == (two, two)


def test_do_bundle_adjust_counts_no_graphed_iteration_on_the_cpu(runs):
    """CPU tensors take BA's derivatives eagerly: every iteration counts,
    none as graphed."""
    *_, steps, _ = runs
    assert (steps["iterations"], steps["graphed_iterations"]) == (ITERATIONS, 0)


def _adjust(case):
    """Bundle adjustment on one thread of the filtered matches of the pair
    (of the triple for "nview") from their first cameras: 2-view in mode
    ``case``, N-view, or the sharded 2-view LM over a 1 x 1 gloo mesh."""
    import torch.distributed as dist

    from ssrlcv_tpu_torch.ba.nview import bundle_adjust_nview
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust_two_view
    from ssrlcv_tpu_torch.config import BAParams
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.parallel import mesh as pm
    from ssrlcv_tpu_torch.parallel.sharded import sharded_bundle_adjust

    _, scene, off, *_ = _runs(3 if case == "nview" else 2)
    cams = cameras_from_refimages(scene.images, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    created = case == "sharded" and pm.initialize_single("gloo")
    try:
        if case == "nview":
            return bundle_adjust_nview(off.matches, cams, BAParams(iterations=ITERATIONS))
        if case == "sharded":
            return sharded_bundle_adjust(pm.make_mesh(1, 1, device_type="cpu"), off.matches,
                                         cams, iterations=ITERATIONS)
        return bundle_adjust_two_view(off.matches, cams, iterations=ITERATIONS, mode=case)
    finally:
        if created:
            dist.destroy_process_group()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ["lm", "newton", "reference", "nview", "sharded"])
def test_accepted_is_the_strict_decreases_of_the_error_history(case):
    r = _adjust(case)
    hist = r.error_history.numpy()
    assert hist.shape == (ITERATIONS + 1,) and hist[0] == float(r.initial_error)
    assert r.accepted.dtype == torch.int64 and r.accepted.shape == ()
    assert int(r.accepted) == int(np.sum(hist[1:] < hist[:-1]))
    if case in ("lm", "nview", "sharded"):
        assert int(r.accepted) > 0
    if case == "reference":  # never applies an update
        assert int(r.accepted) == 0
    assert r.column_cameras is (case != "nview")


def test_sharded_ba_opens_the_spans_of_two_view_ba():
    """Over a 1 x 1 mesh the sharded LM opens the ba.* spans of the
    single-device LM on the same tracks, in the same order, and takes the
    same steps."""
    from ssrlcv_tpu_torch.logging import logger

    def traced(case):
        calls = []

        def listener(name, begin):
            calls.append((name, begin))

        logger.add_span_listener(listener)
        try:
            return calls, _adjust(case)
        finally:
            logger.remove_span_listener(listener)

    (single, r1), (sharded, r2) = traced("lm"), traced("sharded")
    assert sharded == single
    opened = [name for name, begin in single if begin]
    assert opened[0] == "stage.ba.setup" and opened[-1] == "stage.ba.final"
    assert opened.count("stage.ba.iteration") == ITERATIONS
    assert torch.equal(r2.error_history, r1.error_history)


@pytest.mark.parametrize("case", ["lm", "newton", "reference", "nview", "sharded"])
def test_ba_on_the_cpu_captures_no_graph(case):
    """Every BA on CPU tensors takes its derivatives eagerly: its result is
    not ``graphed`` and it opens no ``ba.capture`` span; ``lm.graphed``
    hands a problem on the CPU back as it is."""
    from ssrlcv_tpu_torch.ba import lm
    from ssrlcv_tpu_torch.logging import logger

    calls = []

    def listener(name, begin):
        calls.append(name)

    logger.add_span_listener(listener)
    try:
        r = _adjust(case)
    finally:
        logger.remove_span_listener(listener)
    assert r.graphed is False
    assert "stage.ba.setup" in calls and "stage.ba.capture" not in calls
    problem = lm.Problem(r.initial_error, None, None, None, None, freeze=False)
    p0 = torch.zeros(12)
    for iterations in (0, ITERATIONS):
        with lm.graphed(problem, p0, iterations) as same:
            assert same is problem
