"""K3 alone at the 2-view benchmark's feature counts, on one CUDA device.

    python -m ssrlcv_tpu_torch.bench.match_kernel [--seed S] [--reps R]

Counterpart of ``scripts/bench_match_kernel.py``: nq = 32768 query and nt =
36352 target descriptors, uniform random bytes, targets at uniform random
locations in [0, 1024)^2, all valid, every segment +inf (the ungated pass),
from ``numpy.random.default_rng(seed)``.  It times K3's preparation
(``match_kernel.prepare``: the orders, then the layout kernel: squared
norms, ``target_meta``, ``tile_boxes``) on the host clock to a
``synchronize``, apart from the kernel on that prepared layout (CUDA
events, ``match_kernel.launch``), and both together
(``match_kernel.best_target``), as the JAX script splits
``_match_prep_i8`` from ``_match_call_i8``.  Utilisation: 2 * 128 int8
operations for each of the nq * nt pairs (all live, all needed) over the
H100's 1,979 TOP/s int8 peak.  Prints one JSON record as the last line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ssrlcv_tpu_torch.bench import scene as S
from ssrlcv_tpu_torch.matching.match_kernel import best_target, launch, prepare

NQ, NT = 32768, 36352  # the benchmark's feature counts


def make_inputs(seed: int = 0, nq: int = NQ, nt: int = NT, device=None) -> tuple:
    """best_target's arguments for the ungated pass on random data: (q, t,
    t_loc, p1, p2, epsilon, t_valid)."""
    from ssrlcv_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 256, (nq, 128)).astype(np.uint8)).to(dev)
    t = torch.from_numpy(rng.integers(0, 256, (nt, 128)).astype(np.uint8)).to(dev)
    t_loc = torch.from_numpy(rng.uniform(0, 1024, (nt, 2)).astype(np.float32)).to(dev)
    inf2 = torch.full((nq, 2), torch.inf, dtype=torch.float32, device=dev)
    return q, t, t_loc, inf2, inf2, 0.0, torch.ones(nt, dtype=torch.bool, device=dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.bench.match_kernel",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    ap.add_argument("--reps", type=int, default=5, help="timed runs after the warm-up")
    args = ap.parse_args(argv)
    dev = S.require_cuda(ap.prog)
    from ssrlcv_tpu_torch.bench.timing import cuda_ms

    inp = make_inputs(args.seed, device=dev)
    best_target.launches = 0
    prep, prep_s = S.min_seconds(lambda: prepare(*inp), dev, args.reps)
    kernel_ms, queued = cuda_ms(lambda: launch(prep), args.reps)
    (idx, dist), e2e_s = S.min_seconds(lambda: best_target(*inp), dev, args.reps)
    if not (torch.equal(idx, launch(prep)[0]) and torch.isfinite(dist).all()):
        raise RuntimeError("K3 on the prepared layout disagrees with best_target")
    nq, nt = inp[0].shape[0], inp[1].shape[0]
    ops = 2 * 128 * nq * nt
    out = {"metric": "match_kernel_s", "value": kernel_ms / 1e3, "unit": "s", "nq": nq, "nt": nt,
           "kernel_s": kernel_ms / 1e3, "kernel_queued": queued, "prep_s": prep_s,
           "e2e_s": e2e_s, "match_ops": ops, "peak_ops_per_s": S.H100_INT8_PER_S,
           "mfu_kernel": ops / (kernel_ms / 1e3) / S.H100_INT8_PER_S,
           "mfu_e2e": ops / e2e_s / S.H100_INT8_PER_S,
           "launches": {"best_target": best_target.launches},
           "device": S.device_record(),
           "scene": {"kind": "random descriptors", "seed": args.seed, "nq": nq, "nt": nt}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
