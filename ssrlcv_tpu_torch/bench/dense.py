"""Dense SIFT of one image on one CUDA device.

    python -m ssrlcv_tpu_torch.bench.dense [--fixture DIR] [--size N] [--seed S] [--gather]
                                           [--out FILE]

Counterpart of ``scripts/bench_dense_tpu.py``: ``generate_dense_sift`` on
image 0, the fast path (stencil orientation field, compaction, one K2
launch) and, with ``--gather``, also the gather path (K1 over every
interior pixel, then K2).  Each path: its first call (cold, host clock to a
``synchronize``) and the least of three more (warm).  Prints one JSON
record as the last line, and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import time

from ssrlcv_tpu_torch.bench import scene as S


def time_path(pixels, fast: bool, device, reps: int = 3):
    """(warm seconds, cold seconds, features) of one dense SIFT path."""
    from ssrlcv_tpu_torch.features.dense import generate_dense_sift

    S.sync(device)
    t0 = time.perf_counter()
    fs = generate_dense_sift(pixels, image_id=0, fast=fast, device=device)
    S.sync(device)
    cold = time.perf_counter() - t0
    _, warm = S.min_seconds(lambda: generate_dense_sift(pixels, image_id=0, fast=fast,
                                                        device=device), device, reps)
    return warm, cold, fs.count()


def main(argv=None, synthetic=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.bench.dense",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", help="a Pipeline2View fixture directory")
    ap.add_argument("--size", type=int, default=1024, help="synthetic scene size")
    ap.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    ap.add_argument("--gather", action="store_true", help="also time the gather path")
    ap.add_argument("--out", help="a file to write the record to")
    args = ap.parse_args(argv)
    dev = S.require_cuda(ap.prog)
    from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
    from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms

    sc = S.load(args.fixture, args.size, args.seed, 2, dev, synthetic=synthetic)
    counters = (orientation_histograms, descriptor_histograms)
    for fn in counters:
        fn.launches = 0
    px = sc.images[0].pixels
    warm, cold, n = time_path(px, True, dev)
    rec = {"metric": "dense_sift_s_per_image", "value": warm, "unit": "s", "cold_s": cold,
           "features": n, "image": "image 0",
           "path": "fast (stencil orientation field + K2 descriptor kernel, device-resident)"}
    if args.gather:
        g_warm, _, g_n = time_path(px, False, dev)
        rec.update(gather_path_s=g_warm, gather_features=g_n)
    rec.update(launches={fn.__name__: fn.launches for fn in counters},
               device=S.device_record(), scene=sc.record)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return rec


if __name__ == "__main__":
    main()
