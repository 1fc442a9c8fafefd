"""2-view bundle adjustment's objective with the cameras reached by view
column (``ba.two_view.make_objective``), against the row gather through
``kp_parent`` (``generate_bundles``), on the CPU.

Where every live slot of a view column has the same parent, the objective
broadcasts that camera's row over the tracks: its value is the row
gather's to the bit, and its gradient and Hessian differ only by the
float32 order of their sums over the tracks.  A column that mixes parents
keeps the row gather.
"""

import dataclasses

import pytest
import torch
from torch.func import grad, hessian

from tests.test_torch_modules import _port_cams, _rig

# gradient and Hessian entries summed over the tracks in another float32
# order: each within this share of the largest entry of the row gather's
DERIV_RTOL = 1e-4

CASES = ["rig", "pair128", "mixed"]


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _rig_case():
    """``_rig()`` with its outliers dropped and camera 1 turned off its
    pose, as the BA tests of test_torch_modules.py take it."""
    from ssrlcv_tpu_torch.core.types import MatchSet

    cams, arrays = _rig()
    arrays["mask"][[7, 123, 301]] = False
    cams = cams.replace(cam_rot=cams.cam_rot.at[1, 1].add(2e-4))
    return MatchSet.from_numpy(**arrays), _port_cams(cams)


def _mixed_case():
    """The rig over three cameras, column 1's parents alternating between
    camera 1 and a copy of it 2 km aside; every tenth row dead (-1)."""
    from ssrlcv_tpu_torch.core.types import Cameras

    ms, cams = _rig_case()
    cams = Cameras(**{f.name: torch.cat([getattr(cams, f.name), getattr(cams, f.name)[1:2]])
                      for f in dataclasses.fields(cams)})
    cams = cams.replace(cam_pos=cams.cam_pos + torch.tensor([[0.0, 0, 0], [0, 0, 0], [0, 2, 0]]))
    parent = ms.kp_parent.clone()
    parent[1::2, 1] = 2
    parent[::10] = -1
    ms = ms.replace(kp_parent=parent, mask=ms.mask & (parent[:, 0] >= 0))
    return ms, cams


@pytest.fixture(scope="module")
def pair128(tmp_path_factory):
    """A seeded 128^2 pair's filtered tracks and cameras: run_pipeline's
    stages 0-4 on the CPU, the state stage 5 starts from."""
    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.pipeline import stages as T
    from ssrlcv_tpu_torch.synthetic import make_scene

    scene = make_scene(seed=0, size=128)
    cfg = PipelineConfig(output_dir=str(tmp_path_factory.mktemp("pair128"))).replace(
        match=MatchParams(epsilon=25.0, delta=5.0), sift=SIFTParams(max_keypoints=4096))
    state = T.PipelineState(config=cfg, images=scene.images, device="cpu")
    state.seed_features = generate_features(scene.seed_image.pixels, cfg.sift, -1,
                                            device="cpu")
    for stage in (T.do_feature_generation, T.do_feature_matching, T.do_triangulation,
                  T.do_filtering):
        state = stage(state)
    assert state.matches.count() > 50
    return state


def _case(name, request):
    if name == "pair128":
        state = request.getfixturevalue("pair128")
        return state.matches, state.cameras
    return _rig_case() if name == "rig" else _mixed_case()


def _row_gather(matches, cameras):
    """The objective through ``generate_bundles``' gather by each slot's
    parent."""
    from ssrlcv_tpu_torch.ba.lm import unpack
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
    from ssrlcv_tpu_torch.geometry.triangulation import linear_error_objective

    return lambda p: linear_error_objective(generate_bundles(matches, unpack(cameras, p)))


def _close(got, want):
    return float((got - want).abs().max()) <= DERIV_RTOL * float(want.abs().max())


@pytest.mark.parametrize("case", CASES)
def test_objective_by_view_column_equals_the_row_gather(case, request):
    """At the input cameras and a step away: the objective equal to the
    row gather's to the bit, gradient and Hessian within DERIV_RTOL; the
    column path taken where every column has one parent, not in "mixed"."""
    from ssrlcv_tpu_torch.ba.lm import pack
    from ssrlcv_tpu_torch.ba.two_view import make_objective, view_columns

    ms, cams = _case(case, request)
    obj, row = make_objective(ms, cams), _row_gather(ms, cams)
    assert obj.column_cameras is (case != "mixed")
    assert (view_columns(ms) is None) is (case == "mixed")
    p0 = pack(cams)
    step = torch.zeros_like(p0)
    step[6:12] = torch.tensor([0.01, -0.02, 0.003, 1e-4, -2e-4, 3e-4])
    for p in (p0, p0 + step):
        got, want = _one_thread(lambda: (obj(p), grad(obj)(p), hessian(obj)(p))), \
            _one_thread(lambda: (row(p), grad(row)(p), hessian(row)(p)))
        assert torch.isfinite(want[0]) and float(want[0]) > 0
        assert torch.equal(got[0], want[0])
        assert _close(got[1], want[1]) and _close(got[2], want[2])


@pytest.mark.parametrize("case", ["rig", "mixed"])
def test_do_bundle_adjust_counts_the_column_path(case, request, tmp_path):
    """Stage 5 on a 2-view state counts one 2-view call, and one column
    call unless a column mixes parents; its errors are those of
    ``bundle_adjust`` on the same inputs."""
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust
    from ssrlcv_tpu_torch.config import PipelineConfig
    from ssrlcv_tpu_torch.pipeline import stages as T

    ms, cams = _case(case, request)
    cfg = PipelineConfig(output_dir=str(tmp_path))
    state = T.PipelineState(config=cfg, images=["view 0", "view 1"], device="cpu",
                            matches=ms, cameras=cams)
    calls, columns = T.do_bundle_adjust.two_view_calls, T.do_bundle_adjust.column_cameras
    state = _one_thread(lambda: T.do_bundle_adjust(state))
    assert T.do_bundle_adjust.two_view_calls == calls + 1
    assert T.do_bundle_adjust.column_cameras == columns + (case != "mixed")
    r = _one_thread(lambda: bundle_adjust(ms, cams, cfg.ba))
    assert r.column_cameras is (case != "mixed")
    assert state.ba_error == (float(r.initial_error), float(r.final_error))
    assert state.ba_error[1] < state.ba_error[0]
