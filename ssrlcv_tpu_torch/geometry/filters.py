"""2-view match-set filters.

Counterpart of ``linear_cutoff_filter`` and
``deterministic_statistical_filter`` in ``ssrlcv_tpu/geometry/filters.py``:
a filter is a function MatchSet -> MatchSet that only clears mask bits, so
order is preserved.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu_torch.core.types import Cameras, MatchSet
from ssrlcv_tpu_torch.geometry.bundles import generate_bundles
from ssrlcv_tpu_torch.geometry.triangulation import two_view_triangulate


def linear_cutoff_filter(matches: MatchSet, cameras: Cameras, cutoff: float) -> MatchSet:
    """Drop tracks whose linear error (squared gap, km^2) exceeds ``cutoff``."""
    pc, _ = two_view_triangulate(generate_bundles(matches, cameras))
    return matches.replace(mask=matches.mask & (pc.errors <= cutoff) & pc.mask)


def deterministic_statistical_filter(matches: MatchSet, cameras: Cameras, sigma: float,
                                     sample_jump: int) -> MatchSet:
    """Sample every ``sample_jump``-th valid track's linear error (in
    compacted order), take the sample variance, and drop tracks with error >
    sigma * stddev."""
    pc, _ = two_view_triangulate(generate_bundles(matches, cameras))
    errors = pc.errors
    valid = matches.mask & pc.mask
    order = torch.cumsum(valid.to(torch.int32), dim=0) - 1
    n_valid = torch.sum(valid.to(torch.int32))
    sample_count = n_valid // sample_jump
    is_sample = valid & (order % sample_jump == 0) & (order < sample_count * sample_jump)
    w = is_sample.to(errors.dtype)
    denom = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(errors * w) / denom
    var = torch.sum(((errors - mean) ** 2) * w) / denom
    cutoff = sigma * torch.sqrt(var)
    return matches.replace(mask=valid & (errors <= cutoff))
