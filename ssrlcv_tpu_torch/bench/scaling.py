"""Scaling of the sharded matcher from 1 to N CUDA devices.

    python -m ssrlcv_tpu_torch.bench.scaling [--seed S] [--reps R]
    torchrun --nproc-per-node 4 -m ssrlcv_tpu_torch.bench.scaling

Counterpart of ``scripts/bench_scaling.py``: ``parallel.sharded.
sharded_best_target`` (K3 on each rank's query shard) on 8192 x 8192
random descriptors, all valid, from ``numpy.random.default_rng(seed)``,
over meshes of the first 1, 2, 4, ... ranks of the process group (a
(size, 1) data x feat mesh; NCCL, one rank per card).  Per size the mean
host seconds of ``--reps`` calls after a warm-up, ending in a
``synchronize``, and the efficiency base / (seconds * size).  Without
torchrun the process starts a one-rank group itself: on one card only size
1 exists, and the record says that it claims nothing about scale-out.
Rank 0 prints one JSON record as the last line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ssrlcv_tpu_torch.bench import scene as S

N = 8192  # queries and targets


def make_inputs(seed: int = 0, n: int = N, device=None) -> tuple:
    """(q, t, t_valid): n random query and target descriptors, all valid."""
    from ssrlcv_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 256, (n, 128)).astype(np.uint8)).to(dev)
    t = torch.from_numpy(rng.integers(0, 256, (n, 128)).astype(np.uint8)).to(dev)
    return q, t, torch.ones(n, dtype=torch.bool, device=dev)


def mesh_sizes(world: int) -> list:
    """1, 2, 4, ... up to ``world``."""
    return [s for s in (1, 2, 4, 8, 16, 32) if s <= world]


def sub_mesh(size: int, device_type: str):
    """A (size, 1) data x feat mesh over ranks 0 .. size-1 of the group;
    every rank of the group must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    from ssrlcv_tpu_torch.parallel.mesh import DATA_AXIS, FEAT_AXIS

    return DeviceMesh(device_type, torch.arange(size).reshape(size, 1),
                      mesh_dim_names=(DATA_AXIS, FEAT_AXIS))


def answer(mesh, q, t, t_valid):
    """(idx, dist) of the sharded matcher over ``mesh``."""
    from ssrlcv_tpu_torch.parallel.sharded import sharded_best_target

    return sharded_best_target(mesh, q, t, t_valid)


def measure(q, t, t_valid, device, reps: int = 5) -> dict:
    """{size: mean seconds of a sharded_best_target call} over every mesh
    size of the group; ranks outside a mesh wait at a barrier."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for s in mesh_sizes(world):
        mesh = sub_mesh(s, device.type)
        if rank < s:
            answer(mesh, q, t, t_valid)
            S.sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                answer(mesh, q, t, t_valid)
            S.sync(device)
            out[s] = (time.perf_counter() - t0) / reps
        dist.barrier()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.bench.scaling",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    ap.add_argument("--reps", type=int, default=5, help="timed calls a size")
    args = ap.parse_args(argv)
    S.require_cuda(ap.prog)
    import torch.distributed as dist

    from ssrlcv_tpu_torch.matching.match_kernel import best_target
    from ssrlcv_tpu_torch.parallel import mesh as pm

    created = pm.initialize_distributed() or pm.initialize_single("nccl")
    try:
        dev = torch.device(f"cuda:{pm.local_rank()}")
        torch.cuda.set_device(dev)
        best_target.launches = 0
        seconds = measure(*make_inputs(args.seed, device=dev), dev, args.reps)
        out = None
        if dist.get_rank() == 0:
            base = seconds[1]
            out = {"metric": "match_scaling_efficiency", "platform": "gpu",
                   "devices": sorted(seconds), "seconds": {str(k): v for k, v in seconds.items()},
                   "efficiency": {str(s): base / (v * s) for s, v in seconds.items()},
                   "launches": {"best_target": best_target.launches},
                   "device": S.device_record(),
                   "scene": {"kind": "random descriptors", "seed": args.seed, "n": N}}
            if dist.get_world_size() == 1:
                out["note"] = ("one rank: only size 1 exists; the record claims nothing about "
                               "scale-out")
            print(json.dumps(out))
    finally:
        if created:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
