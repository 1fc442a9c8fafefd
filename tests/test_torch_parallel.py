"""The port's multi-device stages (ssrlcv_tpu_torch.parallel) against the
JAX package's (ssrlcv_tpu.parallel), on the CPU with gloo.

In process, on a one-rank gloo group (a 1 x 1 mesh), each sharded stage is
held against its JAX sharded twin on the conftest's 8-device virtual mesh
and against the port's single-device path, on the same numpy-seeded inputs.
Then tests/torch_parallel_worker.py runs as 2 gloo ranks (a 2 x 1 mesh) and
as 4 (2 x 2, so that the MIN over the feat axis is real), each run with its
own 90 s timeout; every rank writes an .npz, and the ranks must agree with
each other and with the JAX package: the matchers, image-parallel SIFT at
128^2, the pair sweep over three images and run_pipeline end to end.  Last,
the command line runs with --mesh auto as two ranks that torchrun's
environment variables describe.

Tolerances are the JAX package's own (tests/test_sharded.py,
tests/two_process_worker.py): matching exact; triangulated points rtol 2e-6
/ atol 1e-4 and the total error rtol 1e-4; BA final error rtol 1e-3 and
end-to-end clouds' masks >= 99 % equal and their points rtol 1e-3 / atol
1e-5.  The JAX references of the worker runs are computed once, on a 2 x 2
JAX mesh: the JAX package's sharded results do not depend on the mesh
shape (tests/test_sharded.py).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_modules import _port_cams, _rig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
RUN_TIMEOUT_S = 90


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(data, feat, out_dir):
    world, port = data * feat, _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(port), str(data),
                              str(feat), out_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT) for r in range(world)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in out, out[-3000:]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Both worker runs, started together; {mesh: [npz of each rank]}."""
    dirs = {name: str(tmp_path_factory.mktemp(f"ranks{name}")) for name in MESHES}
    procs = {name: _launch(*dims, dirs[name]) for name, dims in MESHES.items()}
    runs = {}
    for name, (data, feat) in MESHES.items():
        _wait(procs[name])
        runs[name] = [dict(np.load(os.path.join(dirs[name], f"rank{r}.npz")))
                      for r in range(data * feat)]
        runs[name + "_dir"] = dirs[name]
    return runs


@pytest.fixture(scope="module")
def mesh11():
    """A one-rank gloo group and its 1 x 1 mesh."""
    import torch.distributed as dist

    from ssrlcv_tpu_torch.parallel import mesh as pm

    assert pm.initialize_single("gloo")
    try:
        yield pm.make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _jax_mesh(data, feat):
    from ssrlcv_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices()[:data * feat], data=data, feat=feat)


def _jax_fs(arrays):
    from ssrlcv_tpu.core.types import FeatureSet

    return FeatureSet(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def scene128():
    from ssrlcv_tpu_torch.synthetic import make_scene

    return make_scene(0, 128, n_views=3)


@pytest.fixture(scope="module")
def scene_feats(scene128):
    """(scene, the port's SIFT of its three views, of its seed image)."""
    from ssrlcv_tpu_torch.features.sift import generate_features
    from torch_parallel_worker import scene_config

    sp = scene_config().sift
    return (scene128, [generate_features(im.pixels, sp, im.id, device="cpu")
                       for im in scene128.images],
            generate_features(scene128.seed_image.pixels, sp, -1, device="cpu"))


# --- in process: a one-rank gloo group -------------------------------------


@pytest.mark.parametrize("gated", [False, True])
def test_sharded_best_target_matches_jax(mesh11, gated):
    """K3's wrapper on the shard (the whole problem on one rank): idx and
    dist equal to the JAX sharded matcher on a 2 x 4 mesh and to the port's
    single-device best_target, on the query mask; (0, +inf) off it."""
    from ssrlcv_tpu.parallel.sharded import sharded_best_target as jax_sbt
    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.parallel.sharded import sharded_best_target

    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (256, 128)).astype(np.uint8)
    t = rng.integers(0, 256, (512, 128)).astype(np.uint8)
    tv = rng.random(512) > 0.1
    qv = np.arange(256) < 240
    kw, jkw = {}, {}
    if gated:
        t_loc = rng.uniform(0, 512, (512, 2)).astype(np.float32)
        p1 = rng.uniform(0, 512, (256, 2)).astype(np.float32)
        p2 = (p1 + rng.normal(0, 60, (256, 2))).astype(np.float32)
        kw = dict(p1=torch.from_numpy(p1), p2=torch.from_numpy(p2),
                  t_loc=torch.from_numpy(t_loc), epsilon=30.0)
        jkw = {k: (jnp.asarray(v.numpy()) if k != "epsilon" else v) for k, v in kw.items()}
    tq, tt, ttv, tqv = (torch.from_numpy(a) for a in (q, t, tv, qv))
    idx, dist = sharded_best_target(mesh11, tq, tt, ttv, q_valid=tqv, **kw)
    jidx, jdist = jax_sbt(_jax_mesh(2, 4), jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv), **jkw)
    jidx, jdist = np.asarray(jidx), np.asarray(jdist)
    if gated:  # some rows have no target in their gate
        assert np.isinf(jdist).any() and np.isfinite(jdist).any()
    np.testing.assert_array_equal(idx.numpy()[qv], jidx[qv])
    np.testing.assert_array_equal(dist.numpy()[qv], jdist[qv])
    assert (idx.numpy()[~qv] == 0).all() and np.isinf(dist.numpy()[~qv]).all()
    inf2 = torch.full((256, 2), torch.inf)
    single = best_target(tq, tt, kw.get("t_loc", torch.zeros(512, 2)), kw.get("p1", inf2),
                         kw.get("p2", inf2), kw.get("epsilon", 0.0), ttv, q_valid=tqv)
    assert torch.equal(idx, single[0]) and torch.equal(dist, single[1])


def test_sharded_best_target_tie_break(mesh11, rank_runs):
    """Equal targets on different shards: the lowest global index wins, as
    in tests/test_sharded.py (here, on the 2 x 2 mesh's feat shards, too)."""
    from ssrlcv_tpu_torch.parallel.sharded import sharded_best_target

    q = torch.zeros((8, 128), dtype=torch.uint8)
    t = torch.ones((64, 128), dtype=torch.uint8)
    t[13] = 0
    t[45] = 0
    idx, dist = sharded_best_target(mesh11, q, t, torch.ones(64, dtype=torch.bool))
    assert (idx == 13).all() and (dist == 0).all()
    for name in MESHES:  # worker: t[300] = t[13] = q[5], 300 on the other feat shard
        assert all(r["bt_idx"][5] == 13 and r["bt_dist"][5] == 0 for r in rank_runs[name])


@pytest.mark.parametrize("mode", ["double", "brute"])
def test_sharded_matchers_match_jax(mesh11, scene_feats, mode):
    """The sharded 2-view matchers: valid, target and distance equal to the
    JAX sharded twins (double on 2 x 4, brute on 8 x 1) and to the port's
    single-device matchers, with seed distances, on the scene's SIFT
    features."""
    from ssrlcv_tpu.config import MatchParams as JMP
    from ssrlcv_tpu.matching import match as JM
    from ssrlcv_tpu.parallel import sharded as JS
    from ssrlcv_tpu_torch.config import MatchParams
    from ssrlcv_tpu_torch.matching import match as M
    from ssrlcv_tpu_torch.parallel import sharded as S

    from ssrlcv_tpu.io.images import cameras_from_refimages

    scene, feats, seed = scene_feats
    arrays = [f.to_numpy() for f in feats[:2] + [seed]]
    f0, f1, sf = feats[0], feats[1], seed
    j0, j1, jsf = (_jax_fs(a) for a in arrays)
    cams = cameras_from_refimages(scene.images[:2])
    kw = dict(epsilon=25.0, delta=5.0, mode=mode)
    sd, jsd = M.seed_distances(f0, sf), JM.seed_distances(j0, jsf)
    if mode == "double":
        got = S.sharded_match_double_constrained(mesh11, f0, f1, _port_cams(cams), 0, 1,
                                                 MatchParams(**kw), seed_dist=sd)
        ref = M.match_double_constrained(f0, f1, _port_cams(cams), 0, 1, MatchParams(**kw),
                                         seed_dist=sd)
        jgot = JS.sharded_match_double_constrained(_jax_mesh(2, 4), j0, j1, cams, 0, 1,
                                                   JMP(**kw), seed_dist=jsd)
    else:
        got = S.sharded_match_brute_force(mesh11, f0, f1, MatchParams(**kw), seed_dist=sd)
        ref = M.match_brute_force(f0, f1, MatchParams(**kw), seed_dist=sd)
        jgot = JS.sharded_match_brute_force(_jax_mesh(8, 1), j0, j1, JMP(**kw), seed_dist=jsd)
    v = np.asarray(jgot.valid)
    assert 0 < v.sum() < len(v)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.target_idx.numpy()[v], np.asarray(jgot.target_idx)[v])
    np.testing.assert_array_equal(got.distance.numpy()[v], np.asarray(jgot.distance)[v])
    # off the query mask the CPU's chunked single-device pass answers the
    # padding rows, K3 gives (0, +inf) (ROADMAP.md, rows outside the query mask)
    qm = f0.mask
    assert torch.equal(got.valid, ref.valid)
    assert torch.equal(got.target_idx[qm], ref.target_idx[qm])
    assert torch.equal(got.distance[qm], ref.distance[qm])


def test_sharded_triangulate_matches_jax(mesh11):
    """Track-sharded triangulation against the JAX twin on 8 x 1 and the
    port's single-device triangulation."""
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu.parallel.sharded import sharded_triangulate as jax_tri
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.geometry.triangulation import triangulate_matches
    from ssrlcv_tpu_torch.parallel.sharded import sharded_triangulate

    cams, arrays = _rig()
    arrays = {k: v[:397] for k, v in arrays.items()}  # not a multiple of the data axis
    pc, err = sharded_triangulate(mesh11, MatchSet.from_numpy(**arrays), _port_cams(cams))
    jpc, jerr = jax_tri(_jax_mesh(8, 1), JMS(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                        cams)
    assert pc.points.shape == (397, 3)
    np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(jpc.mask))
    np.testing.assert_allclose(pc.points.numpy(), np.asarray(jpc.points), rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-4)
    spc, serr = triangulate_matches(MatchSet.from_numpy(**arrays), _port_cams(cams))
    assert torch.equal(pc.points, spc.points) and torch.equal(pc.mask, spc.mask)
    assert float(err) == pytest.approx(float(serr), rel=1e-6)


def _perturbed_rig():
    cams, arrays = _rig()
    arrays["mask"][[7, 123, 301]] = False  # drop the outliers
    return cams.replace(cam_rot=cams.cam_rot.at[1, 1].add(2e-4)), arrays


def test_sharded_ba_step_matches_jax(mesh11):
    """One sharded LM step: the summed error equal to the JAX package's
    objective at the start (rtol 1e-4); the new camera state equal to the
    port's dense step (the single-device objective's gradient and Hessian;
    rtol 1e-4 / atol 1e-7, as tests/test_sharded.py holds the JAX twin to
    its dense step); camera 0 pinned.  (The JAX twin's own step is not the
    yardstick: from this start one step at lambda 1e-3 overshoots along the
    valley the linear error barely constrains, by an amount a float32
    rounding of H changes; the LM loop rejects it in both packages, which
    test_sharded_bundle_adjust_matches_jax holds.)"""
    from torch.func import grad, hessian

    from ssrlcv_tpu.ba.two_view import _pack
    from ssrlcv_tpu.ba.two_view import make_objective as jax_objective
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu_torch.ba import lm
    from ssrlcv_tpu_torch.ba.two_view import make_objective
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.parallel.sharded import sharded_ba_step

    cams, arrays = _perturbed_rig()
    jobj = jax.jit(jax_objective(JMS(**{k: jnp.asarray(v) for k, v in arrays.items()}), cams))
    p0 = np.asarray(_pack(cams))
    ms, tc = MatchSet.from_numpy(**arrays), _port_cams(cams)
    tp0 = lm.pack(tc)
    p, err = sharded_ba_step(mesh11, ms, tc, tp0, 1e-3)
    e0 = float(jobj(jnp.asarray(p0)))
    assert float(err) == pytest.approx(e0, rel=1e-4)
    obj, free = make_objective(ms, tc), lm.free_params(2, tp0, True)
    dense = tp0 - lm.damped_solve(hessian(obj)(tp0), grad(obj)(tp0), torch.tensor(1e-3), free)
    np.testing.assert_allclose(p.numpy(), dense.numpy(), rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(p.numpy()[:6], p0.reshape(-1)[:6])


def test_sharded_bundle_adjust_matches_jax(mesh11):
    """The distributed LM loop, 4 iterations: initial error rtol 1e-4 and
    final error rtol 1e-3 against the JAX twin on 8 x 1 (the port's cameras
    differ from JAX's by ~1e-3 relative along the flat valley, as its
    single-device LM's do, tests/test_torch_modules.py); the error history,
    cameras and cloud equal to the port's single-device LM (the same
    decisions)."""
    from ssrlcv_tpu.core.types import MatchSet as JMS
    from ssrlcv_tpu.parallel.sharded import sharded_bundle_adjust as jax_ba
    from ssrlcv_tpu_torch.ba.two_view import bundle_adjust_two_view
    from ssrlcv_tpu_torch.core.types import MatchSet
    from ssrlcv_tpu_torch.parallel.sharded import sharded_bundle_adjust

    cams, arrays = _perturbed_rig()
    ms, tc = MatchSet.from_numpy(**arrays), _port_cams(cams)
    got = sharded_bundle_adjust(mesh11, ms, tc, iterations=4)
    ref = jax_ba(_jax_mesh(8, 1), JMS(**{k: jnp.asarray(v) for k, v in arrays.items()}), cams,
                 iterations=4)
    assert float(got.initial_error) == pytest.approx(float(ref.initial_error), rel=1e-4)
    assert float(got.final_error) == pytest.approx(float(ref.final_error), rel=1e-3)
    assert float(got.final_error) < float(got.initial_error)
    single = bundle_adjust_two_view(ms, tc, iterations=4, mode="lm")
    assert torch.equal(got.error_history, single.error_history)
    assert torch.equal(got.cameras.cam_rot, single.cameras.cam_rot)
    assert torch.equal(got.cloud.mask, single.cloud.mask)


def test_mesh_helpers(mesh11):
    """make_mesh refuses a shape that is not the world size; the ragged
    all-gather and host_value give each rank's rows back."""
    from ssrlcv_tpu_torch.parallel import mesh as pm

    with pytest.raises(ValueError, match="world size 1"):
        pm.make_mesh(2, 2, device_type="cpu")
    assert (pm.axis_size(mesh11, pm.DATA_AXIS), pm.flat_rank(mesh11), mesh11.size()) == (1, 0, 1)
    x = torch.arange(6).reshape(3, 2)
    (g,) = pm.all_gather_ragged(x, mesh11)
    assert torch.equal(g, x)
    (e,) = pm.all_gather_ragged(x[:0], mesh11)
    assert e.shape == (0, 2)
    assert torch.equal(pm.host_value(x, mesh11, pm.DATA_AXIS), x)
    m = torch.tensor([True, False])
    assert torch.equal(pm.host_value(m, mesh11), m)
    x = torch.tensor([3.0, -1.0])
    assert torch.equal(pm.all_reduce(x, "MIN", mesh11), x)
    assert not pm.initialize_distributed()  # one process, a group already: nothing to do


def test_pipeline_stages_over_the_mesh(mesh11, scene_feats, tmp_path):
    """run_pipeline with a 1 x 1 mesh takes every distributed branch on the
    128^2 scene (2 views and 3) and ends in the single-device state."""
    from ssrlcv_tpu_torch.pipeline import stages as S
    from torch_parallel_worker import scene_config

    scene, _, seed = scene_feats
    cfg = scene_config().replace(output_dir=str(tmp_path))
    for images in (scene.images[:2], scene.images):
        got = S.run_pipeline(S.PipelineState(config=cfg, images=images, device="cpu",
                                             seed_features=seed, mesh=mesh11))
        ref = S.run_pipeline(S.PipelineState(config=cfg, images=images, device="cpu",
                                             seed_features=seed))
        assert got.matches.count() > 40
        for a, b in zip(got.features, ref.features):
            assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in vars(a))
        assert torch.equal(got.matches.kp_loc, ref.matches.kp_loc)
        assert torch.equal(got.cloud.mask, ref.cloud.mask)
        np.testing.assert_allclose(got.cloud.points.numpy(), ref.cloud.points.numpy(),
                                   rtol=2e-6, atol=1e-4)
        assert got.ba_error[1] == pytest.approx(ref.ba_error[1], rel=1e-3)


# --- gloo ranks in subprocesses: 2 x 1 and 2 x 2 ---------------------------


@pytest.fixture(scope="module")
def jax_sift(scene128):
    """The JAX package's SIFT of the scene's three views (its CPU path,
    which its sharded SIFT reproduces exactly)."""
    from ssrlcv_tpu.features.sift import generate_features
    from torch_parallel_worker import scene_config

    sp = scene_config().sift
    return [generate_features(im.pixels, sp, image_id=im.id) for im in scene128.images]


def _ranks_agree(ranks):
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def _fields(run, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in run.items() if k.startswith(prefix + "_")}


@pytest.fixture(scope="module")
def jax_matchers(scene128):
    """The JAX sharded matchers on the worker's matcher inputs (2 x 2)."""
    from ssrlcv_tpu.config import MatchParams as JMP
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu.parallel import sharded as JS
    from torch_parallel_worker import matcher_inputs

    jm = _jax_mesh(2, 2)
    q, t, tv, feats = matcher_inputs()
    out = dict(zip(("bt_idx", "bt_dist"), JS.sharded_best_target(
        jm, jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv))))
    j0, j1 = (_jax_fs(dict(loc=loc, sigma=np.ones(len(m), np.float32),
                           theta=np.zeros(len(m), np.float32), descriptors=d, mask=m,
                           parent=np.full(len(m), i, np.int32)))
              for i, (loc, d, m) in enumerate(feats))
    cams = cameras_from_refimages(scene128.images[:2])
    for name, dm in (("double", JS.sharded_match_double_constrained(
            jm, j0, j1, cams, 0, 1, JMP(epsilon=200.0, delta=5.0))),
                     ("brute", JS.sharded_match_brute_force(jm, j0, j1, JMP()))):
        out.update({f"{name}_valid": dm.valid, f"{name}_idx": dm.target_idx,
                    f"{name}_dist": dm.distance})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_matcher_matches_jax(rank_runs, mesh, jax_matchers):
    """Every rank returns the same full result; sharded_best_target and
    both 2-view matchers equal the JAX sharded twins."""
    ranks = rank_runs[mesh]
    _ranks_agree(ranks)
    run, ref = ranks[0], jax_matchers
    np.testing.assert_array_equal(run["bt_idx"], ref["bt_idx"])
    np.testing.assert_array_equal(run["bt_dist"], ref["bt_dist"])
    for name in ("double", "brute"):
        v = ref[f"{name}_valid"]
        assert v.sum() > 0, name
        np.testing.assert_array_equal(run[f"{name}_valid"], v)
        np.testing.assert_array_equal(run[f"{name}_idx"][v], ref[f"{name}_idx"][v])
        np.testing.assert_array_equal(run[f"{name}_dist"][v], ref[f"{name}_dist"][v])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_sift_matches_jax(rank_runs, mesh, scene128, jax_sift):
    """Image-parallel SIFT (3 images over 2 or 4 ranks: padding slots, an
    idle rank) equals the port's generate_features on each image exactly,
    and the JAX package's within its 0.5 % feature count
    (tests/test_torch_slice.py)."""
    from ssrlcv_tpu_torch.features.sift import generate_features
    from torch_parallel_worker import scene_config

    run = rank_runs[mesh][0]
    for i, im in enumerate(scene128.images):
        ref = generate_features(im.pixels, scene_config().sift, image_id=im.id, device="cpu")
        for k, v in ref.to_numpy().items():
            np.testing.assert_array_equal(run[f"sift{i}_{k}"], v, err_msg=f"image {i} {k}")
        nj = int(np.asarray(jax_sift[i].mask).sum())
        assert nj > 300 and abs(int(run[f"sift{i}_mask"].sum()) - nj) <= 0.005 * nj


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_pair_sweep_matches_jax(rank_runs, mesh, scene128):
    """The pair sweep over the three views' features (from the ranks), modes
    "double" and "brute" with seed distances: per pair equal to the JAX
    package's pairwise_index_matches on the same features."""
    from ssrlcv_tpu.config import MatchParams as JMP
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu.matching.tracks import pairwise_index_matches
    from ssrlcv_tpu_torch.features.sift import generate_features
    from torch_parallel_worker import scene_config

    run = rank_runs[mesh][0]
    feats = [_jax_fs(_fields(run, f"sift{i}")) for i in range(3)]
    seed = generate_features(scene128.seed_image.pixels, scene_config().sift, -1, device="cpu")
    jseed = _jax_fs(seed.to_numpy())
    cams = cameras_from_refimages(scene128.images)
    total = 0
    for mode in ("double", "brute"):
        ref = pairwise_index_matches(feats, cams, JMP(mode=mode, epsilon=25.0, delta=5.0),
                                     seed_features=jseed)
        assert set(ref) == {(0, 1), (0, 2), (1, 2)}
        for (i, j), m in ref.items():
            np.testing.assert_array_equal(run[f"pairs_{mode}_{i}{j}"], m, err_msg=f"{mode} {i}{j}")
            total += len(m)
    assert total > 100


@pytest.fixture(scope="module")
def jax_pipeline(rank_runs, scene128, tmp_path_factory):
    """The JAX package's stages 2-5 over a 2 x 2 mesh on the pair, from the
    features and seed features the ranks computed."""
    from ssrlcv_tpu.config import MatchParams as JMP
    from ssrlcv_tpu.config import PipelineConfig as JPC
    from ssrlcv_tpu.config import SIFTParams as JSP
    from ssrlcv_tpu.io import ply
    from ssrlcv_tpu.io.images import cameras_from_refimages
    from ssrlcv_tpu.pipeline import stages as J
    from ssrlcv_tpu_torch.features.sift import generate_features
    from torch_parallel_worker import scene_config

    run = rank_runs["2x1"][0]
    out = str(tmp_path_factory.mktemp("jax_pipeline"))
    seed = generate_features(scene128.seed_image.pixels, scene_config().sift, -1, device="cpu")
    cfg = JPC(output_dir=out).replace(match=JMP(epsilon=25.0, delta=5.0),
                                      sift=JSP(max_keypoints=1024))
    js = J.PipelineState(config=cfg, images=scene128.images[:2], mesh=_jax_mesh(2, 2))
    js.cameras = cameras_from_refimages(js.images)
    js.features = [_jax_fs(_fields(run, f"sift{i}")) for i in range(2)]
    js.seed_features = _jax_fs(seed.to_numpy())
    for stage in (J.do_feature_matching, J.do_triangulation, J.do_filtering, J.do_bundle_adjust):
        js = stage(js)
    return (ply.read_ply(os.path.join(out, "ssrlcv-initial.ply"))["points"],
            np.asarray(js.cloud.mask), np.asarray(js.cloud.points), js.ba_error)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_pipeline_matches_jax(rank_runs, mesh, jax_pipeline):
    """run_pipeline over the mesh on the 128^2 pair against the JAX
    package's stages over a mesh from the same features: the initial cloud
    (stage 3, one point per match) equal in count and within rtol 2e-6 /
    atol 1e-4, the BA cloud's mask >= 99 % equal and its points within rtol
    1e-3 / atol 1e-5, the BA final error within rtol 1e-3."""
    from ssrlcv_tpu_torch.io import ply

    run = rank_runs[mesh][0]
    jinitial, jmask, jpoints, jba = jax_pipeline
    initial = ply.read_ply(os.path.join(rank_runs[mesh + "_dir"], "p0", "ssrlcv-initial.ply"))
    assert len(initial["points"]) == len(jinitial) > 40
    np.testing.assert_allclose(initial["points"], jinitial, rtol=2e-6, atol=1e-4)
    gm = run["cloud_mask"]
    n = min(len(gm), len(jmask))
    assert jmask.sum() > 40 and (gm[:n] == jmask[:n]).mean() >= 0.99
    both = gm[:n] & jmask[:n]
    np.testing.assert_allclose(run["cloud_points"][:n][both], jpoints[:n][both],
                               rtol=1e-3, atol=1e-5)
    assert run["ba_error"][1] == pytest.approx(jba[1], rel=1e-3)
    assert run["ba_error"][1] <= run["ba_error"][0]


def test_cli_mesh_under_two_processes(tmp_path):
    """The command line with --mesh auto as two gloo ranks that torchrun's
    environment describes: each rank joins the group, runs the distributed
    stages over the 2 x 1 mesh and writes its own -p{rank} output and
    checkpoint directories, with the same clouds."""
    from ssrlcv_tpu_torch.io import ply
    from ssrlcv_tpu_torch.synthetic import make_scene, write_scene_dir

    d = str(tmp_path / "images")
    write_scene_dir(make_scene(0, 128), d)
    out, ck, port = str(tmp_path / "out"), str(tmp_path / "ck"), _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
        env.update(WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, WORKER, "cli", d, out, ck], cwd=REPO,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    _wait(procs)
    assert not os.path.exists(out) and not os.path.exists(ck)
    clouds = []
    for r in range(2):
        assert sorted(os.listdir(f"{ck}-p{r}")) == [f"sfm-stage{i}" for i in range(6)]
        with open(os.path.join(f"{out}-p{r}", "ssrlcv.log")) as f:
            assert "distributed stages over mesh {'data': 2, 'feat': 1}" in f.read()
        clouds.append([ply.read_ply(os.path.join(f"{out}-p{r}", f"{name}.ply"))["points"]
                       for name in ("ssrlcv-initial", "ssrlcv-filtered", "ssrlcv-BA-final")])
    assert len(clouds[0][0]) > 40
    for a, b in zip(*clouds):
        np.testing.assert_array_equal(a, b)
