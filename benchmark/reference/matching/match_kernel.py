"""K3: epipolar-gated best target per query (wrapper, plain version).

Replaces the Pallas kernel ``ssrlcv_tpu/matching/pallas_match.py``
(``_match_kernel_i8``, public ``pallas_best_target``).  The CUDA kernel is
``csrc/match.cu``; its plain PyTorch twin is ``best_target_plain``:
``distance.best_target_chunked`` with the double-constrained gate of
``match._epipolar_segment_mask``.  Both the seed pass (unconstrained) and
the constrained match go through ``best_target``.

In this frozen copy ``best_target`` takes the plain version on every
device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.reference.matching.distance import best_target_chunked


def epipolar_segment_mask(p1, p2, t_loc, epsilon: float) -> torch.Tensor:
    """The double-constrained acceptance test: x-range gate around the
    segment plus the vertical-segment test or the vertical distance to the
    segment's line.  p1, p2: (C, 2); t_loc: (Nt, 2) -> (C, Nt) bool."""
    swap = p1[:, 0] >= p2[:, 0]
    left = torch.where(swap[:, None], p2, p1)
    right = torch.where(swap[:, None], p1, p2)
    tx = t_loc[None, :, 0]
    ty = t_loc[None, :, 1]

    in_x = (tx >= (left[:, 0] - epsilon)[:, None]) & (tx <= (right[:, 0] + epsilon)[:, None])

    vertical = (left[:, 0] == right[:, 0])[:, None]
    top = torch.minimum(p1[:, 1], p2[:, 1])[:, None]
    bottom = torch.maximum(p1[:, 1], p2[:, 1])[:, None]
    vert_ok = (top - epsilon <= ty) & (bottom + epsilon >= ty)

    dx = left[:, 0] - right[:, 0]
    slope = (left[:, 1] - right[:, 1]) / torch.where(dx == 0, 1.0, dx)
    y_line = slope[:, None] * (tx - left[:, 0][:, None]) + left[:, 1][:, None]
    line_ok = torch.abs(y_line - ty) <= epsilon

    return in_x & torch.where(vertical, vert_ok, line_ok)


def _no_match(idx, dist, q_valid):
    """(0, +inf) on the rows where ``q_valid`` is false."""
    if q_valid is None:
        return idx, dist
    return torch.where(q_valid, idx, 0), torch.where(q_valid, dist, torch.inf)


def best_target_plain(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid, chunk: int = 1024,
                      q_valid=None):
    """(idx int32, dist float32) per query; rows with a non-finite p1.x are
    unconstrained; rows with ``q_valid`` false get (0, +inf)."""
    def gate(a, b):
        return epipolar_segment_mask(a, b, t_loc, epsilon) | ~torch.isfinite(a[:, 0:1])

    return _no_match(*best_target_chunked(q_desc, t_desc, t_valid, mask_fn=gate,
                                          mask_aux=(p1, p2), chunk=chunk), q_valid)


def best_target(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid, q_valid=None):
    """Best valid target per query and its exact squared-L2 distance: the
    plain version on every device."""
    return best_target_plain(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid, q_valid=q_valid)
