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


def best_target_chunked(q_desc, t_desc, t_valid, mask_fn: Optional[Callable] = None,
                        mask_aux: tuple = (), chunk: int = 1024):
    """argmin over valid targets per query, ``chunk`` queries at a time.

    ``mask_fn(*aux_chunk)`` -> (chunk, Nt) bool of allowed targets, where
    ``mask_aux`` holds per-query tensors chunked alongside the descriptors.
    Returns (best_idx int32, best_dist float32); a query with no allowed
    target gets (0, +inf); ties resolve to the lowest target index."""
    idx_out, dist_out = [], []
    for s in range(0, q_desc.shape[0], chunk):
        d = distance_matrix(q_desc[s:s + chunk], t_desc).to(torch.float32)
        bad = ~t_valid[None, :]
        if mask_fn is not None:
            bad = bad | ~mask_fn(*(a[s:s + chunk] for a in mask_aux))
        d = torch.where(bad, torch.inf, d)
        idx = torch.argmin(d, dim=1)
        idx_out.append(idx.to(torch.int32))
        dist_out.append(torch.gather(d, 1, idx[:, None])[:, 0])
    if not idx_out:
        dev = q_desc.device
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev))
    return torch.cat(idx_out), torch.cat(dist_out)


def min_distance(q_desc, t_desc, t_valid, chunk: int = 1024) -> torch.Tensor:
    """Per-query minimum distance to any valid target."""
    return best_target_chunked(q_desc, t_desc, t_valid, chunk=chunk)[1]
