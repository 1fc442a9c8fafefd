"""N-view exhaustive matching and track building.

Counterpart of ``ssrlcv_tpu/matching/tracks.py``.  Every image pair is
matched on the features' device (the constrained K3 pass, or brute force)
with the index-only family's unsquared relative-seed threshold; the
transitive-chain track assembly runs on the host, a line-for-line
transliteration of the JAX package's (and so of the reference's): in Python
over ints for CPU features (``build_tracks``), in the native library for
CUDA features (``build_track_slots``, ``csrc/tracks.cu``, the same tracks in
the same order).  Its quirks:

  * adjacency entries are sorted by (image, feature): the pair loop emits
    them in target-image order;
  * a chain is accepted only if each next hop's adjacency set is a subset of
    the previous one (a full set-intersection check), rejected otherwise;
  * tracks are rooted only at query images 0..n-3 (the reference's loop
    guard ``i < images.size() - 2``);
  * consumed adjacency lists are cleared, so no keypoint is in two tracks.

Spans (``logger.span``): ``tracks.sweep`` (the windowed pair sweep), each
``tracks.fetch`` (a host read of a pair's matches), ``tracks.build`` (the
track assembly, a logged phase) and ``tracks.assemble`` (the MatchSet).
Counters: ``generate_matches_exhaustive.calls`` and ``.native_calls`` (the
calls whose tracks the native builder made).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ssrlcv_tpu_torch.config import MatchParams
from ssrlcv_tpu_torch.logging import logger
from ssrlcv_tpu_torch.core.types import Cameras, FeatureSet, MatchSet

# pair passes queued ahead of the oldest fetch: deep enough to keep the card
# busy while the host reads earlier results, shallow enough to bound the
# match buffers alive at once
DISPATCH_WINDOW = 16


def overlap_pairs(n: int, ordered: bool, estimated_overlap: float) -> list:
    """The (i < j) pairs to match; for an ordered capture only pairs close
    enough in the sequence to overlap: (j - i) * (1 - overlap) <= 1."""
    return [
        (i, j)
        for i in range(n - 1)
        for j in range(i + 1, n)
        if not (ordered and estimated_overlap > 0.0
                and (j - i) * (1.0 - estimated_overlap) > 1.0)
    ]


def pairwise_index_matches(features: list, cameras: Cameras, params: MatchParams,
                           seed_features: Optional[FeatureSet] = None, ordered: bool = False,
                           estimated_overlap: float = 0.0, mesh=None) -> dict:
    """Best-match index pairs of every kept (i < j) image pair, with a seed
    distance pass per new query image.  Returns {(i, j): (n, 2) int64 array
    of (query feature, target feature)}.  ``mesh``: a (data, feat)
    DeviceMesh (``parallel.mesh``); pair k then goes to flattened rank k %
    ranks, and every rank's results are gathered
    (``parallel.sharded._allgather_pair_matches``), so every rank returns
    the same per-pair results as the serial sweep."""
    from ssrlcv_tpu_torch.matching import match as M

    pairs = overlap_pairs(len(features), ordered, estimated_overlap)
    mine = pairs
    if mesh is not None:
        from ssrlcv_tpu_torch.parallel.mesh import flat_rank

        mine = pairs[flat_rank(mesh)::mesh.size()]
    # a rank's pairs keep the list's order, so each query image's seed
    # distances are computed once
    state = {"sd": None, "sd_img": -1}

    def dispatch(k, ij):
        i, j = ij
        if seed_features is not None and state["sd_img"] != i:
            state["sd"] = M.seed_distances(features[i], seed_features)
            state["sd_img"] = i
        if params.mode == "double":
            return M.match_double_constrained(features[i], features[j], cameras, i, j, params,
                                              seed_dist=state["sd"], index_only=True)
        return M.match_brute_force(features[i], features[j], params, seed_dist=state["sd"],
                                   index_only=True)

    with logger.span("tracks.sweep"):
        local = windowed_pair_sweep(mine, dispatch, DISPATCH_WINDOW)
    if mesh is None:
        return local
    from ssrlcv_tpu_torch.parallel.sharded import _allgather_pair_matches

    return _allgather_pair_matches(local, pairs, mesh, features[0].loc.device)


def windowed_pair_sweep(pairs: list, dispatch, window: int) -> dict:
    """Queue up to ``window`` pair passes ahead of the fetches: on a CUDA
    device the passes run while the host reads earlier results, and each
    fetch (one copy to the host) is the only synchronisation.

    ``dispatch(k, pair)`` -> DMatches; returns {pair: (n, 2) int64 array of
    (query feature, target feature)}."""
    dms, out = {}, {}

    def fetch(key):
        with logger.span("tracks.fetch"):
            dm = dms.pop(key)
            valid = dm.valid.cpu().numpy()
            qf = np.nonzero(valid)[0]
            tf = dm.target_idx.cpu().numpy()[qf]
            out[key] = np.stack([qf, tf], axis=1).astype(np.int64)

    for k, ij in enumerate(pairs):
        dms[ij] = dispatch(k, ij)
        if k >= window:
            fetch(pairs[k - window])
    for key in list(dms.keys()):
        fetch(key)
    return out


def build_tracks(pair_matches: dict, num_images: int, feature_counts: list) -> list:
    """Adjacency-chain track assembly.  Returns a list of tracks, each a list
    of (image, feature) pairs.  Hops are packed into ints (code = image *
    stride + feature), so the chain checks are set operations on ints."""
    stride = max(feature_counts) + 1 if feature_counts else 1
    last = num_images - 1
    adjacency: list = [{} for _ in range(num_images - 1)]
    for (i, j), pairs in sorted(pair_matches.items()):
        jbase = j * stride
        adj_i = adjacency[i]
        for qf, tf in pairs.tolist():
            code = jbase + tf
            lst = adj_i.get(qf)
            if lst is None:
                adj_i[qf] = [code]
            else:
                lst.append(code)
    # entries are appended in increasing j, so each list is sorted

    tracks: list = []
    for i in range(num_images - 2):
        adj_i = adjacency[i]
        for f in sorted(adj_i.keys()):
            adj = adj_i[f]
            if not adj:
                continue
            bad = False
            prev_adj = adj
            prev_set = None
            while True:
                jx, jy = divmod(prev_adj[0], stride)
                if jx == last:
                    break
                next_adj = adjacency[jx].get(jy)
                if not next_adj:
                    break
                # every next-hop entry must already be in the previous
                # adjacency (entries are unique by construction)
                if prev_set is None:
                    prev_set = set(prev_adj)
                if not prev_set.issuperset(next_adj):
                    bad = True
                    break
                elif len(next_adj) == 1:
                    break
                else:
                    prev_adj = next_adj
                    prev_set = set(next_adj)
            if bad:
                adj_i[f] = []
            else:
                tracks.append([(i, f)] + [divmod(c, stride) for c in adj])
                # clear the consumed adjacency (all but the last hop)
                for c in adj[:-1]:
                    mx, my = divmod(c, stride)
                    if mx == last:
                        break
                    adjacency[mx][my] = []
    return tracks


def track_slots(tracks: list) -> np.ndarray:
    """A track list as (S, 4) int64 rows (track, slot, image, feature),
    tracks in order and each track's slots in order."""
    return np.array([(k, s, img, feat) for k, tr in enumerate(tracks)
                     for s, (img, feat) in enumerate(tr)], np.int64).reshape(-1, 4)


def build_track_slots(pair_matches: dict, num_images: int, feature_counts: list):
    """``build_tracks`` in the native library (``csrc/tracks.cu``): returns
    (``track_slots(build_tracks(...))``, the number of tracks), equal to
    them.  ``pair_matches`` as ``build_tracks`` takes it, each value an
    (n, 2) int64 array.  Host work only: no launch, no device memory."""
    from ssrlcv_tpu_torch import _cuda

    stride = max(feature_counts) + 1 if feature_counts else 1
    keys = sorted(pair_matches)
    for i, j in keys:
        if not 0 <= i < j < num_images:
            raise ValueError(f"pair ({i}, {j}) is not an image pair i < j < {num_images}")
    rows = [pair_matches[k] for k in keys]
    for k, r in zip(keys, rows):
        if not isinstance(r, np.ndarray) or r.dtype != np.int64:
            raise TypeError(f"pair {k}: matches must be an int64 numpy array, got "
                            f"{getattr(r, 'dtype', type(r))}")
        if r.ndim != 2 or r.shape[1] != 2:
            raise ValueError(f"pair {k}: matches must be (n, 2), got {r.shape}")
    flat = np.ascontiguousarray(np.concatenate(rows) if rows else np.zeros((0, 2), np.int64))
    if flat.size and (flat.min() < 0 or flat.max() >= stride):
        raise ValueError(f"feature indices must lie in [0, {stride}), got "
                         f"[{flat.min()}, {flat.max()}]")
    ij = np.array(keys, np.int64).reshape(-1, 2)
    start = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int64)
    slots = np.empty((max(2 * len(flat), 1), 4), np.int64)
    counts = np.zeros(2, np.int64)
    rc = _cuda.library().ssrlcv_build_tracks(
        ij.ctypes.data, start.ctypes.data, flat.ctypes.data, len(keys), num_images, stride,
        len(slots), slots.ctypes.data, counts.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"ssrlcv_build_tracks refused its input ({rc})")
    return slots[:counts[1]], int(counts[0])


def generate_matches_exhaustive(features: list, cameras: Cameras, params: MatchParams,
                                seed_features: Optional[FeatureSet] = None,
                                ordered: bool = False,
                                estimated_overlap: float = 0.0, mesh=None) -> MatchSet:
    """Full N-view matching -> a padded MatchSet on the features' device
    (capacity: the track count rounded up to 128, at least 128).  ``mesh``:
    distribute the pair sweep over its ranks; every rank builds the same
    tracks."""
    pair_matches = pairwise_index_matches(features, cameras, params, seed_features,
                                          ordered=ordered, estimated_overlap=estimated_overlap,
                                          mesh=mesh)
    generate_matches_exhaustive.calls += 1
    counts = [f.capacity for f in features]
    with logger.phase("tracks.build"):
        if features[0].loc.device.type == "cuda":
            slots, t = build_track_slots(pair_matches, len(features), counts)
            generate_matches_exhaustive.native_calls += 1
        else:
            tracks = build_tracks(pair_matches, len(features), counts)
            slots, t = track_slots(tracks), len(tracks)
    with logger.span("tracks.assemble"):
        return _matchset(slots, t, features)


generate_matches_exhaustive.calls = 0
generate_matches_exhaustive.native_calls = 0


def _matchset(slots: np.ndarray, num_tracks: int, features: list) -> MatchSet:
    """Slot rows (track, slot, image, feature) of ``num_tracks`` tracks as a
    padded MatchSet on the features' device, each keypoint's location
    gathered there from its image's ``loc``."""
    dev = features[0].loc.device
    t = num_tracks
    k, s, img, feat = slots.T
    lengths = np.bincount(k, minlength=t)
    v = int(lengths.max()) if t else 2
    cap = max(((t + 127) // 128) * 128, 128)
    base = np.cumsum([0] + [f.capacity for f in features[:-1]])
    src = torch.from_numpy(base[img] + feat).to(dev)
    kp_loc = torch.zeros((cap * v, 2), dtype=torch.float32, device=dev)
    kp_loc[torch.from_numpy(k * v + s).to(dev)] = torch.cat([f.loc for f in features])[src]
    kp_par = np.full((cap, v), -1, np.int32)
    kp_par[k, s] = img
    nviews = np.zeros(cap, np.int32)
    nviews[:t] = lengths
    return MatchSet(kp_loc=kp_loc.view(cap, v, 2), kp_parent=torch.from_numpy(kp_par).to(dev),
                    num_views=torch.from_numpy(nviews).to(dev),
                    mask=torch.from_numpy(np.arange(cap) < t).to(dev))
