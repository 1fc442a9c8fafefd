"""2-view skew-line midpoint triangulation and its linear-error objective.

Counterpart of the 2-view part of ``ssrlcv_tpu/geometry/triangulation.py``.
Reductions are single deterministic ``torch.sum`` calls.
"""

from __future__ import annotations

import math

import torch

from ssrlcv_tpu_torch.core.types import Bundles, PointCloud


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, written out (jnp.cross's formula):
    torch.func has no batching rule for linalg.cross and would loop over
    the Hessian's tangents one by one."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def two_view_midpoints(l1_vec, l1_pnt, l2_vec, l2_pnt):
    """Closest points s1, s2 of two skew lines."""
    cr = _cross(l1_vec, l2_vec)
    n2 = _cross(l2_vec, cr)
    n1 = _cross(l1_vec, cr)
    numer1 = torch.sum((l2_pnt - l1_pnt) * n2, dim=-1)
    numer2 = torch.sum((l1_pnt - l2_pnt) * n1, dim=-1)
    denom1 = torch.sum(l1_vec * n2, dim=-1)
    denom2 = torch.sum(l2_vec * n1, dim=-1)
    s1 = l1_pnt + (numer1 / denom1)[..., None] * l1_vec
    s2 = l2_pnt + (numer2 / denom2)[..., None] * l2_vec
    return s1, s2


def _masked_safe_lines(bundles: Bundles):
    """Substitute well-conditioned skew lines for masked (padding) tracks, so
    their 0/0 never reaches a gradient (0 * nan = nan would poison BA).
    Valid tracks pass through untouched."""
    m = bundles.mask[:, None]
    dt, dev = bundles.vec.dtype, bundles.vec.device
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev)
    l1_vec = torch.where(m, bundles.vec[:, 0], e1)
    l2_vec = torch.where(m, bundles.vec[:, 1], e2)
    l1_pnt = torch.where(m, bundles.pnt[:, 0], 0.0)
    l2_pnt = torch.where(m, bundles.pnt[:, 1], e3)
    return l1_vec, l1_pnt, l2_vec, l2_pnt


def two_view_triangulate(bundles: Bundles, cutoff: float = math.inf):
    """Midpoint triangulation with per-point linear error ||s1 - s2||^2.
    Points with error > cutoff are masked out.  Returns (PointCloud,
    total_linear_error)."""
    l1_vec, l1_pnt, l2_vec, l2_pnt = _masked_safe_lines(bundles)
    s1, s2 = two_view_midpoints(l1_vec, l1_pnt, l2_vec, l2_pnt)
    point = (s1 + s2) / 2.0
    err = torch.sum((s1 - s2) ** 2, dim=-1)
    valid = bundles.mask & (err <= cutoff)
    err_masked = torch.where(bundles.mask, err, 0.0)
    total = torch.sum(torch.where(valid, err_masked, 0.0))
    return PointCloud(points=point, errors=err_masked, mask=valid), total


def triangulate_matches(matches, cameras, cutoff: float = math.inf):
    """Bundle generation + 2-view triangulation."""
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles

    return two_view_triangulate(generate_bundles(matches, cameras), cutoff)


def linear_error_objective(bundles: Bundles) -> torch.Tensor:
    """Differentiable total linear error: the 2-view BA objective."""
    l1_vec, l1_pnt, l2_vec, l2_pnt = _masked_safe_lines(bundles)
    s1, s2 = two_view_midpoints(l1_vec, l1_pnt, l2_vec, l2_pnt)
    err = torch.sum((s1 - s2) ** 2, dim=-1)
    return torch.sum(torch.where(bundles.mask, err, 0.0))
