"""Exact descriptor distances (plain PyTorch).

Counterpart of ``ssrlcv_tpu/matching/distance.py``.  Squared L2 between
uint8 descriptors is an integer <= 128*255^2 < 2^24.  The cross term is a
float32 product of the centred (u8 - 128) descriptors: every partial sum is
an integer below 2^21 in magnitude, so float32 holds it exactly in any
summation order (with TF32 off, see the package docstring).  These are the
plain versions that kernel K3 (``match_kernel.py``) is held against.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _centred(desc: torch.Tensor) -> torch.Tensor:
    return desc.to(torch.float32) - 128.0


def distance_matrix(q_desc: torch.Tensor, t_desc: torch.Tensor) -> torch.Tensor:
    """(Nq, 128) x (Nt, 128) uint8 -> (Nq, Nt) int32 exact squared L2."""
    q = _centred(q_desc)
    t = _centred(t_desc)
    qn = (q * q).sum(1).to(torch.int32)
    tn = (t * t).sum(1).to(torch.int32)
    cross = (q @ t.T).to(torch.int32)
    return qn[:, None] + tn[None, :] - 2 * cross


def sad_matrix(q_desc: torch.Tensor, t_desc: torch.Tensor) -> torch.Tensor:
    """(Nq, D) x (Nt, D) uint8 -> (Nq, Nt) int32 exact sum of absolute
    differences (the Window_NxN distance).  Every partial sum is an integer
    below 2^24, so the float32 L1 distance is exact in any order."""
    return torch.cdist(q_desc.to(torch.float32), t_desc.to(torch.float32), p=1).to(torch.int32)


_METRICS = {"l2sq": distance_matrix, "sad": sad_matrix}


def best_target_chunked(q_desc, t_desc, t_valid, mask_fn: Optional[Callable] = None,
                        mask_aux: tuple = (), chunk: int = 1024, metric: str = "l2sq",
                        t_aux: tuple = ()):
    """argmin over valid targets per query, ``chunk`` queries at a time.

    Only the valid targets enter the distances: a capacity padded far past
    its live rows costs what the live rows cost.  ``mask_fn(*aux_chunk,
    *t_aux_valid)`` -> (chunk, Nv) bool of allowed targets among the Nv
    valid ones, where ``mask_aux`` holds per-query tensors chunked alongside
    the descriptors and ``t_aux`` per-target tensors, given at the valid
    targets.  Returns (best_idx int32, best_dist float32) in the targets'
    own indices; a query with no allowed target gets (0, +inf); ties
    resolve to the lowest target index.  metric: 'l2sq' (squared L2, SIFT)
    or 'sad' (sum of absolute differences, Window_NxN)."""
    dist_fn = _METRICS[metric]
    nq, dev = q_desc.shape[0], q_desc.device
    live = torch.nonzero(t_valid).squeeze(1)
    if nq == 0 or live.shape[0] == 0:
        return (torch.zeros((nq,), dtype=torch.int32, device=dev),
                torch.full((nq,), torch.inf, dtype=torch.float32, device=dev))
    t_live = t_desc[live]
    aux_live = tuple(a[live] for a in t_aux)
    idx_out, dist_out = [], []
    for s in range(0, nq, chunk):
        d = dist_fn(q_desc[s:s + chunk], t_live).to(torch.float32)
        if mask_fn is not None:
            d = torch.where(mask_fn(*(a[s:s + chunk] for a in mask_aux), *aux_live), d, torch.inf)
        j = torch.argmin(d, dim=1)
        best = torch.gather(d, 1, j[:, None])[:, 0]
        idx_out.append(torch.where(torch.isfinite(best), live[j], 0).to(torch.int32))
        dist_out.append(best)
    return torch.cat(idx_out), torch.cat(dist_out)


def min_distance(q_desc, t_desc, t_valid, chunk: int = 1024,
                 metric: str = "l2sq") -> torch.Tensor:
    """Per-query minimum distance to any valid target."""
    return best_target_chunked(q_desc, t_desc, t_valid, chunk=chunk, metric=metric)[1]
