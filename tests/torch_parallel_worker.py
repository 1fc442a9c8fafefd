"""One rank of the port's multi-process gloo runs (tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py <rank> <world> <port> <data> <feat> <out_dir>

Joins a gloo group of ``world`` processes through
``ssrlcv_tpu_torch.parallel.mesh.initialize_distributed``, builds the
(data, feat) mesh and, on the CPU, runs the sharded stages on numpy-seeded
inputs:

  * matcher: ``sharded_best_target`` (with ties across feat shards),
    ``sharded_match_double_constrained`` and ``sharded_match_brute_force``;
  * SIFT: ``sharded_generate_features`` on the 128x128 synthetic scene's
    three views;
  * pairs: the N-view pair sweep over those three feature sets, modes
    "double" and "brute", with seed distances;
  * pipeline: ``run_pipeline`` end to end on the scene's pair over the mesh.

Writes ``rank<rank>.npz`` into ``out_dir``; the parent holds every rank's
file against the JAX package.

    python tests/torch_parallel_worker.py cli <image_dir> <out> <ckpt>

runs the command line with ``--mesh auto --device cpu`` (the capacity of
``scene_config``), as one rank of a group that torchrun's environment
variables describe.  Imports nothing of jax.
"""

import os
import sys

import numpy as np


def matcher_inputs():
    """Seeded descriptors (ties across shards) and feature sets, as numpy."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (256, 128)).astype(np.uint8)
    t = rng.integers(0, 256, (384, 128)).astype(np.uint8)
    t[300] = t[13]  # equal targets in different feat shards: the lowest index wins
    q[5] = t[13]
    tv = rng.random(384) > 0.1
    tv[[13, 300]] = True
    feats = []
    for n in (256, 384):
        loc = rng.uniform(0, 1024, (n, 2)).astype(np.float32)
        desc = rng.integers(0, 256, (n, 128)).astype(np.uint8)
        feats.append((loc, desc, np.arange(n) < n - 16))
    feats[1][1][:100] = feats[0][1][:100]  # true matches
    return q, t, tv, feats


def scene_config():
    from ssrlcv_tpu_torch.config import MatchParams, PipelineConfig, SIFTParams

    return PipelineConfig().replace(match=MatchParams(epsilon=25.0, delta=5.0),
                                    sift=SIFTParams(max_keypoints=1024))


def main(rank, world, port, data, feat, out_dir):
    import torch

    torch.set_num_threads(1)
    from ssrlcv_tpu_torch.config import MatchParams
    from ssrlcv_tpu_torch.core.types import FeatureSet
    from ssrlcv_tpu_torch.features.sift import generate_features
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages
    from ssrlcv_tpu_torch.matching.tracks import pairwise_index_matches
    from ssrlcv_tpu_torch.parallel import mesh as pm
    from ssrlcv_tpu_torch.parallel import sharded
    from ssrlcv_tpu_torch.pipeline.stages import PipelineState, run_pipeline
    from ssrlcv_tpu_torch.synthetic import make_scene

    assert pm.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = pm.make_mesh(data, feat, device_type="cpu")
    out = {}

    q, t, tv, feats = matcher_inputs()
    idx, dist = sharded.sharded_best_target(mesh, torch.from_numpy(q), torch.from_numpy(t),
                                            torch.from_numpy(tv))
    out["bt_idx"], out["bt_dist"] = idx.numpy(), dist.numpy()
    scene = make_scene(0, 128, n_views=3)
    cams = cameras_from_refimages(scene.images[:2], "cpu")
    f0, f1 = (FeatureSet.from_numpy(loc=loc, sigma=np.ones(len(m), np.float32),
                                    theta=np.zeros(len(m), np.float32), descriptors=d, mask=m,
                                    parent=np.full(len(m), i, np.int32))
              for i, (loc, d, m) in enumerate(feats))
    for name, dm in (("double", sharded.sharded_match_double_constrained(
            mesh, f0, f1, cams, 0, 1, MatchParams(epsilon=200.0, delta=5.0))),
                     ("brute", sharded.sharded_match_brute_force(mesh, f0, f1, MatchParams()))):
        out[f"{name}_valid"] = dm.valid.numpy()
        out[f"{name}_idx"] = dm.target_idx.numpy()
        out[f"{name}_dist"] = dm.distance.numpy()

    cfg = scene_config()
    sift = sharded.sharded_generate_features(mesh, [im.pixels for im in scene.images],
                                             [im.id for im in scene.images], cfg.sift,
                                             device="cpu")
    for i, fs in enumerate(sift):
        for k, v in fs.to_numpy().items():
            out[f"sift{i}_{k}"] = v
    seed = generate_features(scene.seed_image.pixels, cfg.sift, -1, device="cpu")
    cams3 = cameras_from_refimages(scene.images, "cpu")
    for mode in ("double", "brute"):
        mp = MatchParams(mode=mode, epsilon=25.0, delta=5.0)
        got = pairwise_index_matches(sift, cams3, mp, seed_features=seed, mesh=mesh)
        for (i, j), m in got.items():
            out[f"pairs_{mode}_{i}{j}"] = m

    cfg = cfg.replace(output_dir=os.path.join(out_dir, f"p{rank}"))
    st = run_pipeline(PipelineState(config=cfg, images=scene.images[:2], device="cpu",
                                    seed_features=seed, mesh=mesh))
    for name, obj in (("matches", st.matches), ("cloud", st.cloud)):
        for k, v in obj.to_numpy().items():
            out[f"{name}_{k}"] = v
    out["ba_error"] = np.array(st.ba_error)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK")


def cli(image_dir, out, ckpt):
    from ssrlcv_tpu_torch.pipeline import sfm

    sfm.PipelineConfig = lambda **kw: scene_config().replace(**kw)
    rc = sfm.main(["-d", image_dir, "-o", out, "-cpdir", ckpt, "--epsilon", "25", "--delta", "5",
                   "--mesh", "auto", "--device", "cpu"])
    print(f"rank {os.environ['RANK']}: OK" if rc == 0 else f"rc {rc}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    a = sys.argv[1:]
    if a[0] == "cli":
        cli(*a[1:])
    else:
        main(int(a[0]), int(a[1]), int(a[2]), int(a[3]), int(a[4]), a[5])
