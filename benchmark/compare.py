"""The comparison that decides ``correct``: a job's outputs, as the timed
path produced them, against the plain reference's reconstruction of the
same scene.

Each number is the worst over the compared jobs (``ba_stalled_pct`` is
their share); each has a limit in the cell's workload file (``limits``),
set from the readings of sound runs and of the control (``calibrate.py``),
or stated by the configuration (``guarantees``).  The numbers:

* ``features_pct`` (stage 0): per image (the views and the seed image), the
  share of features with no twin on the other side, the larger of the two
  directions.  A twin has the same location and scale to the bit, an
  orientation within ``THETA_TOL`` rad and every descriptor byte within
  ``DESC_TOL``: detection is plain PyTorch on both sides, K1 and K2 are held
  to their plain versions within rounding.
* ``initial_pct`` (stages 2-3): the initial cloud the job wrote (one point a
  match), as a multiset of float32 points against the reference's; a twin
  is the same point to the bit.
* ``filtered_pct`` (stage 4): the filtered tracks and the cloud the job
  wrote for them; a twin is the same track (every view's keypoint to the
  bit) with the same point to the bit.
* ``surface_m``: the median distance of the filtered cloud from the
  scene's true surface, its sphere: a truth neither side computed.  (Not
  the adjusted cloud: 2-view bundle adjustment with camera 0 pinned shrinks
  the linear error by moving camera 1, and on these scenes carries the
  cloud kilometres off the sphere, on both sides alike.)

Stage 5 is judged a stage at a time, on the job's own filtered tracks.
Bundle adjustment's float32 sums decide whether a step is taken, so a
sound change of their order ends it elsewhere, kilometres away on these
scenes and with a final error some percent apart; one differing track of
thousands does the same.  So neither its cloud nor its error is held to
the reference's adjustment, only what no sound order changes:

* ``ba_cloud_pct``: the share of tracks whose adjusted point lies more than
  ``BA_TOL_M`` from the reference's triangulation of the track through the
  job's adjusted cameras.
* ``ba_stalled_pct``: of the compared jobs whose scene the reference's
  adjustment moves, the share whose adjustment left every camera as the
  views gave it, to the bit.  A sound order of the sums can also reject
  the first steps and stop (one job in 36), so one stalled job is no
  fault; all of them are.
* ``ba_rise``: the adjusted error less the initial one, over the initial
  one; bundle adjustment keeps its best parameters, so it never rises.
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter, defaultdict

import numpy as np
import torch

THETA_TOL = 1e-3   # rad: K1's histograms are within rtol 1e-4 of their plain version
DESC_TOL = 3       # uint8: K2 is within 1 of its plain version, 3 with its inputs' rounding
BA_TOL_M = 1.0     # m: a point off its cameras' triangulation, or moved (16 m a pixel)

NUMBERS = ("features_pct", "initial_pct", "filtered_pct", "ba_cloud_pct", "ba_stalled_pct",
           "surface_m", "ba_rise")


@dataclasses.dataclass
class JobOutputs:
    """A job's outputs on the host: per image (views, then the seed image)
    a dict of loc, sigma, theta, desc; the clouds as written; the filtered
    tracks with the adjusted cameras and cloud; the adjustment's errors."""

    features: list
    initial: np.ndarray       # (n, 3) float32: the initial cloud
    filtered: np.ndarray      # (m, 3) float32: the filtered cloud
    tracks: np.ndarray        # (m,) object: the filtered tracks' keys
    matches: dict             # the filtered tracks: kp_loc, kp_parent, num_views, mask
    ba_cameras: tuple         # (cam_pos, cam_rot), each (N, 3) float32: adjusted
    ba_points: np.ndarray     # (m, 3) float32: the adjusted cloud, by track
    ba_error: tuple           # (initial, final)


def read_ply_points(path: str) -> np.ndarray:
    """The (n, 3) float32 vertices of a binary little-endian PLY whose
    vertices carry x, y, z floats only."""
    with open(path, "rb") as f:
        n = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            words = line.decode("ascii").split()
            if words[:2] == ["element", "vertex"]:
                n = int(words[2])
            if words == ["format", "ascii", "1.0"]:
                raise ValueError(f"{path}: ascii PLY")
            if words == ["end_header"]:
                break
        data = np.frombuffer(f.read(12 * n), "<f4")
    return data.reshape(n, 3).astype(np.float32)


def feature_arrays(fs) -> dict:
    """The live rows of a FeatureSet (either side's type) on the host."""
    m = fs.mask.cpu().numpy()
    return {"loc": fs.loc.cpu().numpy()[m], "sigma": fs.sigma.cpu().numpy()[m],
            "theta": fs.theta.cpu().numpy()[m], "desc": fs.descriptors.cpu().numpy()[m]}


def track_keys(matches) -> np.ndarray:
    """One hashable key per live track of a MatchSet (either side's type):
    its (view, x, y) slots sorted, locations by their float32 bits."""
    loc = matches.kp_loc.cpu().numpy().astype(np.float32).view(np.uint32)
    par = matches.kp_parent.cpu().numpy()
    nv = matches.num_views.cpu().numpy()
    live = np.nonzero(matches.mask.cpu().numpy())[0]
    keys = np.empty(len(live), object)
    for k, t in enumerate(live):
        keys[k] = tuple(sorted((int(par[t, s]), int(loc[t, s, 0]), int(loc[t, s, 1]))
                               for s in range(int(nv[t]))))
    return keys


def match_arrays(matches) -> dict:
    """A MatchSet's arrays on the host."""
    return {k: getattr(matches, k).cpu().numpy()
            for k in ("kp_loc", "kp_parent", "num_views", "mask")}


def cameras_arrays(cams) -> tuple:
    """(cam_pos, cam_rot) of a Cameras (either side's type) on the host."""
    return (cams.cam_pos.detach().cpu().numpy().astype(np.float32),
            cams.cam_rot.detach().cpu().numpy().astype(np.float32))


def reference_ba(job: JobOutputs, views, config, device) -> dict:
    """What the reference makes of the job's stage 5, on the job's own
    filtered tracks and the views' cameras (``cameras0``): its own
    adjustment (``cameras``, ``points`` by track, ``error`` (initial,
    final)), and its triangulation before any adjustment (``start``) and
    through the job's adjusted cameras (``at_job``)."""
    from benchmark.reference.core.types import MatchSet
    from benchmark.reference.pipeline import bundle_adjust, cameras_of, triangulate

    ms = MatchSet.from_numpy(device=device, **job.matches)
    cams = cameras_of(views, device)
    adjusted = cams.replace(cam_pos=torch.as_tensor(job.ba_cameras[0], device=device),
                            cam_rot=torch.as_tensor(job.ba_cameras[1], device=device))
    ref_cams, cloud, err = bundle_adjust(ms, cams, config)
    live = job.matches["mask"]

    def by_track(pc):
        return pc.points.detach().cpu().numpy()[live].astype(np.float32)

    return {"cameras0": cameras_arrays(cams), "cameras": cameras_arrays(ref_cams),
            "points": by_track(cloud), "error": err, "start": by_track(triangulate(ms, cams)),
            "at_job": by_track(triangulate(ms, adjusted))}


def from_program(state, seed_features, job_dir: str) -> JobOutputs:
    """A job's outputs: the state ``run_pipeline`` left (features, the
    filtered tracks, the adjusted cloud and errors), the seed features and
    the clouds the job wrote under ``job_dir``."""
    live = state.matches.mask.cpu().numpy()
    nan = float("nan")
    return JobOutputs(
        features=[feature_arrays(f) for f in list(state.features) + [seed_features]],
        initial=read_ply_points(os.path.join(job_dir, "ssrlcv-initial.ply")),
        filtered=read_ply_points(os.path.join(job_dir, "ssrlcv-filtered.ply")),
        tracks=track_keys(state.matches), matches=match_arrays(state.matches),
        ba_cameras=cameras_arrays(state.cameras), ba_points=state.cloud.points.detach().cpu().numpy()[live].astype(np.float32),
        ba_error=tuple(float(e) for e in state.ba_error) if state.ba_error else (nan, nan))


def from_reference(out) -> JobOutputs:
    """The same outputs of ``reference.pipeline.reconstruct``."""
    live = out.filtered.mask.cpu().numpy()
    return JobOutputs(
        features=[feature_arrays(f) for f in list(out.features) + [out.seed_features]],
        initial=out.initial.compact().astype(np.float32),
        filtered=out.cloud.compact().astype(np.float32),
        tracks=track_keys(out.filtered), matches=match_arrays(out.filtered),
        ba_cameras=cameras_arrays(out.ba_cameras),
        ba_points=out.ba_cloud.points.detach().cpu().numpy()[live].astype(np.float32),
        ba_error=out.ba_error)


def _share_missing(n_a: int, n_b: int, twins: int) -> float:
    """100 x the larger share of either side without a twin."""
    if n_a == 0 or n_b == 0:
        return 0.0 if n_a == n_b else 100.0
    return 100.0 * max(1.0 - twins / n_a, 1.0 - twins / n_b)


def features_pct(a: dict, b: dict) -> float:
    """Twins: the same (x, y, sigma) bits, |d theta| <= THETA_TOL (on the
    circle), every descriptor byte within DESC_TOL; each used once."""
    pool = defaultdict(list)
    for j, key in enumerate(_feature_keys(b)):
        pool[key].append(j)
    twins = 0
    for i, key in enumerate(_feature_keys(a)):
        cands = pool.get(key)
        if not cands:
            continue
        for n, j in enumerate(cands):
            d = abs(float(a["theta"][i]) - float(b["theta"][j])) % (2 * np.pi)
            if (min(d, 2 * np.pi - d) <= THETA_TOL
                    and int(np.abs(a["desc"][i].astype(np.int16)
                                   - b["desc"][j].astype(np.int16)).max()) <= DESC_TOL):
                twins += 1
                del cands[n]
                break
    return _share_missing(len(a["sigma"]), len(b["sigma"]), twins)


def _feature_keys(f: dict):
    loc = np.ascontiguousarray(f["loc"], np.float32).view(np.uint32)
    sig = np.ascontiguousarray(f["sigma"], np.float32).view(np.uint32)
    return zip(loc[:, 0].tolist(), loc[:, 1].tolist(), sig.tolist())


def _point_keys(p: np.ndarray):
    return map(tuple, np.ascontiguousarray(p, np.float32).view(np.uint32).tolist())


def points_pct(a: np.ndarray, b: np.ndarray) -> float:
    """Twins: equal float32 points, as multisets."""
    ca, cb = Counter(_point_keys(a)), Counter(_point_keys(b))
    return _share_missing(len(a), len(b), sum((ca & cb).values()))


def tracks_pct(keys_a, pts_a, keys_b, pts_b) -> float:
    """Twins: the same track, with points equal to the bit."""
    index = dict(zip(keys_b, range(len(keys_b))))
    twins = 0
    for i, key in enumerate(keys_a):
        j = index.get(key)
        if j is None:
            continue
        twins += bool(np.array_equal(pts_a[i].view(np.uint32), pts_b[j].view(np.uint32)))
    return _share_missing(len(keys_a), len(keys_b), twins)


def _gap_m(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Metres between two (m, 3) clouds in km, point by point."""
    return np.linalg.norm(a.astype(np.float64) - b.astype(np.float64), axis=1) * 1e3


def ba_readings(prog: JobOutputs, ref_ba: dict) -> dict:
    """The numbers of stage 5 (``ref_ba`` from ``reference_ba``)."""
    off = ~(_gap_m(prog.ba_points, ref_ba["at_job"]) <= BA_TOL_M)   # NaN is off

    def same(a, b):
        return all(np.array_equal(x.view(np.uint32), y.view(np.uint32)) for x, y in zip(a, b))

    stepped = not same(ref_ba["cameras"], ref_ba["cameras0"])
    return {"ba_cloud_pct": float(100.0 * off.sum() / len(off)) if len(off) else 0.0,
            "ba_stalled_pct": (100.0 * same(prog.ba_cameras, ref_ba["cameras0"]) if stepped
                               else None)}


def readings(prog: JobOutputs, ref: JobOutputs, ref_ba: dict, scene) -> dict:
    """Every number of one job: ``ref`` the reference's reconstruction of
    its scene, ``ref_ba`` what the reference makes of the job's stage 5
    (``reference_ba``), ``scene`` the job's ``scene.Scene``."""
    feats = max(features_pct(a, b) for a, b in zip(prog.features, ref.features))
    pts = torch.as_tensor(prog.filtered)
    surf = (float(torch.median(scene.surface_distance_m(pts))) if len(pts) else float("inf"))
    e0, e1 = prog.ba_error
    return {"features_pct": feats,
            "initial_pct": points_pct(prog.initial, ref.initial),
            "filtered_pct": tracks_pct(prog.tracks, prog.filtered, ref.tracks, ref.filtered),
            **ba_readings(prog, ref_ba),
            "surface_m": surf,
            "ba_rise": (e1 - e0) / e0 if e0 > 0 else float("inf")}


def worst(per_job: list) -> dict:
    """Each number over the jobs: the largest reading (NaN counts as
    failing: it is carried through); for ``ba_stalled_pct`` the mean of the
    jobs that have one, else 0."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in per_job if r[k] is not None]
        if k == "ba_stalled_pct":
            out[k] = sum(vals) / len(vals) if vals else 0.0
        else:
            out[k] = float("nan") if any(v != v for v in vals) else max(vals)
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a missing or NaN reading fails."""
    checks = {k: {"value": None if values.get(k) is None else float(values[k]),
                  "limit": limits[k]} for k in NUMBERS}
    ok = all(c["value"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
