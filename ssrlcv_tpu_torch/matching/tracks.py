"""N-view exhaustive matching and track building.

Counterpart of ``ssrlcv_tpu/matching/tracks.py``.  Every image pair is
matched on the features' device (the constrained K3 pass, or brute force)
with the index-only family's unsquared relative-seed threshold; the
transitive-chain track assembly is host Python over ints, a line-for-line
transliteration of the JAX package's (and so of the reference's), with its
quirks:

  * adjacency entries are sorted by (image, feature): the pair loop emits
    them in target-image order;
  * a chain is accepted only if each next hop's adjacency set is a subset of
    the previous one (a full set-intersection check), rejected otherwise;
  * tracks are rooted only at query images 0..n-3 (the reference's loop
    guard ``i < images.size() - 2``);
  * consumed adjacency lists are cleared, so no keypoint is in two tracks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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
    with logger.phase("build_tracks"):
        tracks = build_tracks(pair_matches, len(features), [f.capacity for f in features])

    locs = [f.loc.cpu().numpy() for f in features]
    t = len(tracks)
    v = max((len(tr) for tr in tracks), default=2)
    cap = max(((t + 127) // 128) * 128, 128)
    kp_loc = np.zeros((cap, v, 2), np.float32)
    kp_par = np.full((cap, v), -1, np.int32)
    nviews = np.zeros(cap, np.int32)
    slots = np.array([(k, s, img, feat) for k, tr in enumerate(tracks)
                      for s, (img, feat) in enumerate(tr)], np.int64).reshape(-1, 4)
    k, s, img, feat = slots.T
    for i, loc in enumerate(locs):
        sel = img == i
        kp_loc[k[sel], s[sel]] = loc[feat[sel]]
    kp_par[k, s] = img
    nviews[:t] = [len(tr) for tr in tracks]
    return MatchSet.from_numpy(device=features[0].loc.device, kp_loc=kp_loc, kp_parent=kp_par,
                               num_views=nviews, mask=np.arange(cap) < t)
