"""Where the SIFT time of one image goes, part by part, on one CUDA device.

    python -m ssrlcv_tpu_torch.bench.profile_sift [--fixture DIR] [--size N] [--seed S]

Counterpart of ``scripts/profile_sift.py`` on image 0.  The parts are
those of ``features.sift.generate_features`` itself, which calls a
``mark`` after each: the scale space (all octaves); per octave the
detection (extrema, refinement, noise and edge rejection, the
descriptor-border check) and the gradients; per blur bucket the
compaction of its keypoints and their description (orientations around
K1, descriptors around K2, with their PyTorch); last the aggregation into
one FeatureSet.  The profiled call records a CUDA event at each mark and
adds no synchronisation: each part's seconds are the stream's time
between its event and the one before, so the parts partition the call,
and their sum lies within its host seconds to a ``synchronize``.  JAX's
script synchronises after each part instead; on the card that counts the
scale space's device time twice over (once in its own part, once behind
the detection's host work).  ``generate_features`` without marks
(``value``, the e2e time) and with them (``pass_s``) run alternately, the
least of five each, host clock to a ``synchronize``.  Per bucket also K1
and K2 alone on its inputs, in device milliseconds from CUDA events
(``bench.timing.cuda_ms``).  JAX's ``_sift_fused`` comparison is TPU
machinery and has no counterpart.

Buckets are count-exact (ROADMAP caveat a): a bucket holds its ``n``
keypoints, with no static capacity.  Prints one line per part, then one
JSON record as the last line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ssrlcv_tpu_torch.bench import scene as S
from ssrlcv_tpu_torch.bench.timing import cuda_ms
from ssrlcv_tpu_torch.config import SIFTParams
from ssrlcv_tpu_torch.features import scale_space as ss
from ssrlcv_tpu_torch.features import sift as F
from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
from ssrlcv_tpu_torch.features.orient_kernel import orientation_histograms

REPS = 5


def detect_all(px, params: SIFTParams) -> list:
    """Scale space, then every octave's keypoints: the detection share of
    ``generate_features``, without gradients and description."""
    h, w = int(px.shape[0]), int(px.shape[1])
    return [F.detect_octave(octave, params, o, h, w)
            for o, octave in enumerate(ss.build_scale_space(px, params, h, w))]


def _collect(px, params: SIFTParams):
    """One ``generate_features`` call on ``px``, keeping what each part
    hands its mark.  Returns (the record: per octave its capacity,
    keypoints and buckets; the record's node of each mark key; the
    buckets' (loc, sigma, theta, descriptors); the buckets' K1 and K2
    inputs)."""
    h, w = int(px.shape[0]), int(px.shape[1])
    top = {"octaves": []}
    nodes = {(): top}
    parts, inputs, held = [], [], {}

    def mark(key, value):
        *path, name = key
        if name == "detect_s":
            o = path[0]
            nodes[(o,)] = {"octave": o, "capacity": F.octave_capacity(params, o, h, w),
                           "keypoints": int(value.mask.sum()), "buckets": []}
            top["octaves"].append(nodes[(o,)])
        elif name == "grads_s":
            held["grads"] = value
        elif name == "aggregate_s":
            top["features"] = value.count()
        elif name == "compact_s":
            held["sel"] = value
        elif name == "describe_s":
            o, b = path
            (oriented, part), sel, (gx, gy) = value, held["sel"], held["grads"]
            w_o, w_d = F._bucket_windows(params, b)
            pw = float(2.0 ** (params.starting_octave + o))
            nodes[(o, b)] = {"blur": b, "w_o": w_o, "w_d": w_d, "n": sel.loc.shape[0],
                             "features": part[0].shape[0]}
            nodes[(o,)]["buckets"].append(nodes[(o, b)])
            parts.append(part)
            inputs.append(((gx[b], gy[b], sel.loc.contiguous(), sel.sigma.contiguous(), pw, w_o,
                            float(params.orientation_contrib_width)),
                           (gx[b], gy[b], oriented.loc.contiguous(), oriented.theta.contiguous(),
                            oriented.sigma.contiguous(), pw,
                            float(params.descriptor_contrib_width), w_d)))

    F.generate_features(px, params, image_id=0, mark=mark)
    for ro in top["octaves"]:
        ro["features"] = sum(rb["features"] for rb in ro["buckets"])
    return top, nodes, parts, inputs


def profile(pixels, params: SIFTParams, device, timed: bool = True):
    """SIFT of ``pixels`` in parts on ``device``.  Returns (record, parts):
    per octave its detection capacity, keypoints and, per bucket,
    keypoints and described features; parts are the buckets' (loc, sigma,
    theta, descriptors) in ``generate_features``' order.

    With ``timed`` (a CUDA device) ``generate_features`` then runs
    ``REPS`` times without marks and ``REPS`` times with a CUDA event at
    each, alternately: ``e2e_s`` is the least host seconds of the first
    (to a ``synchronize``), ``pass_s`` of the second, and of that marked
    call each part's seconds are the stream's time between its event and
    the one before, so the parts partition its device timeline.  Per
    bucket also K1 and K2 alone on its inputs (``k1_ms``, ``k2_ms``,
    ``bench.timing.cuda_ms``)."""
    px = torch.as_tensor(pixels, device=device)
    rec, nodes, parts, inputs = _collect(px, params)
    if not timed:
        return rec, parts
    e2e, best = [], None
    for _ in range(REPS):
        S.sync(device)
        t0 = time.perf_counter()
        F.generate_features(px, params, image_id=0, device=device)
        S.sync(device)
        e2e.append(time.perf_counter() - t0)
        marks = []

        def mark(key, value=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((key, ev))

        S.sync(device)
        t0 = time.perf_counter()
        mark(None)
        F.generate_features(px, params, image_id=0, device=device, mark=mark)
        S.sync(device)
        host = time.perf_counter() - t0
        if best is None or host < best[0]:
            best = (host, marks)
    rec["e2e_s"], (rec["pass_s"], marks) = min(e2e), best
    for (_, a), (key, b) in zip(marks, marks[1:]):
        *path, name = key
        nodes[tuple(path)][name] = a.elapsed_time(b) / 1e3
    buckets = [rb for ro in rec["octaves"] for rb in ro["buckets"]]
    for rb, (k1, k2) in zip(buckets, inputs):
        if rb["n"]:
            rb["k1_ms"], rb["k1_queued"] = cuda_ms(lambda: orientation_histograms(*k1), 3)
        if rb["features"]:
            rb["k2_ms"], rb["k2_queued"] = cuda_ms(lambda: descriptor_histograms(*k2), 3)
    return rec, parts


def main(argv=None, synthetic=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ssrlcv_tpu_torch.bench.profile_sift",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", help="a Pipeline2View fixture directory")
    ap.add_argument("--size", type=int, default=1024, help="synthetic scene size")
    ap.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    args = ap.parse_args(argv)
    dev = S.require_cuda(ap.prog)
    sc = S.load(args.fixture, args.size, args.seed, 2, dev, synthetic=synthetic)
    params = SIFTParams()
    px = sc.images[0].pixels
    counters = (orientation_histograms, descriptor_histograms)
    for fn in counters:
        fn.launches = 0
    rec, _ = profile(px, params, dev)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"scale_space(all octaves): {rec['scale_space_s'] * 1e3:9.3f} ms")
    totals = {"scale_space": rec["scale_space_s"], "detect": 0.0, "grads": 0.0, "compact": 0.0,
              "describe": 0.0, "aggregate": rec["aggregate_s"]}
    kernels_ms = {"k1": 0.0, "k2": 0.0}
    for ro in rec["octaves"]:
        o = ro["octave"]
        print(f"oct{o} detect (cap {ro['capacity']:6d}, {ro['keypoints']:6d} kept): "
              f"{ro['detect_s'] * 1e3:9.3f} ms")
        print(f"oct{o} gradients:            {ro['grads_s'] * 1e3:9.3f} ms")
        totals["detect"] += ro["detect_s"]
        totals["grads"] += ro["grads_s"]
        for rb in ro["buckets"]:
            totals["compact"] += rb["compact_s"]
            totals["describe"] += rb["describe_s"]
            kernels_ms["k1"] += rb.get("k1_ms", 0.0)
            kernels_ms["k2"] += rb.get("k2_ms", 0.0)
            print(f"oct{o} blur{rb['blur']} (n {rb['n']:5d} -> {rb['features']:5d} features, "
                  f"w_o {rb['w_o']:2d}, w_d {rb['w_d']:2d}): compact {rb['compact_s'] * 1e3:7.3f} "
                  f"ms, describe {rb['describe_s'] * 1e3:7.3f} ms, of which K1 "
                  f"{rb.get('k1_ms', 0.0):.4f} ms + K2 {rb.get('k2_ms', 0.0):.4f} ms (CUDA events)")
    print("totals:", {k: f"{v * 1e3:.3f} ms" for k, v in totals.items()},
          "kernels alone:", {k: f"{v:.4f} ms" for k, v in kernels_ms.items()})
    e2e, parts = rec["e2e_s"], sum(totals.values())
    print(f"aggregation: {rec['aggregate_s'] * 1e3:9.3f} ms")
    print(f"generate_features e2e: {e2e * 1e3:9.3f} ms; with marks {rec['pass_s'] * 1e3:.3f} ms, "
          f"its parts {parts * 1e3:.3f} ms, remainder {(rec['pass_s'] - parts) * 1e3:.3f} ms")
    out = {"metric": "sift_e2e_s", "value": e2e, "unit": "s", "features": rec["features"],
           "pass_s": rec["pass_s"], "totals_s": totals, "kernels_ms": kernels_ms,
           "sum_of_parts_s": parts, "unattributed_s": rec["pass_s"] - parts,
           "scale_space_s": rec["scale_space_s"], "octaves": rec["octaves"],
           "launches": launches, "device": S.device_record(), "scene": sc.record}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
