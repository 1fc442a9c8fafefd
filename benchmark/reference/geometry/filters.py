"""Match-set filters.

Counterpart of ``ssrlcv_tpu/geometry/filters.py``: a filter is a function
MatchSet -> MatchSet that only clears mask bits, so order is preserved;
``compact_matchset`` is the one physical compaction.  Every filter takes
``pushbrooms`` and then triangulates pushbroom rays.
"""

from __future__ import annotations

import torch

from benchmark.reference.core.types import Cameras, MatchSet
from benchmark.reference.geometry.bundles import generate_bundles
from benchmark.reference.geometry.triangulation import n_view_triangulate, two_view_triangulate


def _cloud(matches: MatchSet, cameras: Cameras, two_view: bool, reference_error_mode: bool,
           pushbrooms=None):
    bd = generate_bundles(matches, cameras, pushbrooms=pushbrooms)
    if two_view:
        return two_view_triangulate(bd)[0]
    return n_view_triangulate(bd, reference_error_mode=reference_error_mode)[0]


def linear_cutoff_filter(matches: MatchSet, cameras: Cameras, cutoff: float,
                         two_view: bool = True, pushbrooms=None) -> MatchSet:
    """Drop tracks whose error (the squared gap in km^2 for 2 views)
    exceeds ``cutoff``."""
    pc = _cloud(matches, cameras, two_view, reference_error_mode=False, pushbrooms=pushbrooms)
    return matches.replace(mask=matches.mask & (pc.errors <= cutoff) & pc.mask)


def _sigma_cutoff(matches: MatchSet, errors: torch.Tensor, valid: torch.Tensor, sample_w,
                  sigma: float) -> MatchSet:
    """Keep valid tracks with error <= sigma * the weighted sample's
    standard deviation."""
    denom = torch.clamp(torch.sum(sample_w), min=1.0)
    mean = torch.sum(errors * sample_w) / denom
    var = torch.sum(((errors - mean) ** 2) * sample_w) / denom
    return matches.replace(mask=valid & (errors <= sigma * torch.sqrt(var)))


def deterministic_statistical_filter(matches: MatchSet, cameras: Cameras, sigma: float,
                                     sample_jump: int, two_view: bool = True,
                                     pushbrooms=None) -> MatchSet:
    """Sample every ``sample_jump``-th valid track's error (in compacted
    order), take the sample variance, and drop tracks with error > sigma *
    stddev.  N-view errors are the reference's (last view's squared distance
    / numLines), so the cutoff reproduces its filtered sets."""
    pc = _cloud(matches, cameras, two_view, reference_error_mode=True, pushbrooms=pushbrooms)
    valid = matches.mask & pc.mask
    order = torch.cumsum(valid.to(torch.int32), dim=0) - 1
    n_valid = torch.sum(valid.to(torch.int32))
    sample_count = n_valid // sample_jump
    is_sample = valid & (order % sample_jump == 0) & (order < sample_count * sample_jump)
    return _sigma_cutoff(matches, pc.errors, valid, is_sample.to(pc.errors.dtype), sigma)


def nondeterministic_statistical_filter(matches: MatchSet, cameras: Cameras,
                                        generator: torch.Generator, sigma: float,
                                        sample_count: int, two_view: bool = True,
                                        pushbrooms=None) -> MatchSet:
    """The same cutoff over ``sample_count`` tracks drawn uniformly, with
    replacement, from the valid tracks by ``generator``."""
    pc = _cloud(matches, cameras, two_view, reference_error_mode=True, pushbrooms=pushbrooms)
    valid = matches.mask & pc.mask
    probs = valid.to(torch.float32)
    if not bool(probs.any()):
        probs = torch.ones_like(probs)  # nothing valid: the cutoff keeps nothing anyway
    idx = torch.multinomial(probs, sample_count, replacement=True, generator=generator)
    counts = torch.bincount(idx, minlength=matches.capacity).to(pc.errors.dtype)
    return _sigma_cutoff(matches, pc.errors, valid, counts, sigma)


def reduce_bundle_set(matches: MatchSet, fraction: float) -> MatchSet:
    """Keep every k-th valid track, k = round(1 / fraction)."""
    jump = max(int(round(1.0 / max(fraction, 1e-9))), 1)
    order = torch.cumsum(matches.mask.to(torch.int32), dim=0) - 1
    return matches.replace(mask=matches.mask & (order % jump == 0))


def compact_matchset(matches: MatchSet) -> MatchSet:
    """The valid tracks packed densely at the front in their order, the
    rest zero; the capacity stays."""
    idx = torch.nonzero(matches.mask).squeeze(1)
    n, cap = idx.shape[0], matches.capacity

    def pack(x):
        out = torch.zeros_like(x)
        out[:n] = x[idx]
        return out

    return MatchSet(kp_loc=pack(matches.kp_loc), kp_parent=pack(matches.kp_parent),
                    num_views=pack(matches.num_views),
                    mask=torch.arange(cap, device=matches.mask.device) < n)
