"""Triangulation: 2-view skew-line midpoints with their linear-error
objective, and N-view least-squares line intersection.

Counterpart of ``ssrlcv_tpu/geometry/triangulation.py``.  Reductions are
single deterministic ``torch.sum`` calls.  Everything here runs under
``torch.func`` (bundle adjustment differentiates it), so nothing is updated
in place.
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
    # made on the device: a tensor copied from the host would wait for the
    # card, and no CUDA graph can capture it
    e1, e2, e3 = torch.eye(3, dtype=bundles.vec.dtype, device=bundles.vec.device)
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


def n_view_triangulate(bundles: Bundles, reference_error_mode: bool = False):
    """Least-squares intersection of each track's lines: S = sum_i (v_i v_i^T
    - I), C = sum_i (v_i v_i^T - I) p_i over the track's views, point =
    S^-1 C.  A singular S (|det| <= 1e-20) masks the track.

    The per-point error is the mean squared point-line distance over the
    track's views; with ``reference_error_mode`` it is the last view's
    squared distance / numLines (the reference kernel overwrites instead of
    accumulating).  Returns (PointCloud, total error).

    The determinant only decides the mask and the solve only sees
    well-posed systems, so a singular track's NaN never reaches a
    derivative.  The distance is sqrt(sum(d * d)), as the JAX package's
    norm, so derivatives agree with it where d = 0 too.
    """
    vec, pnt = bundles.vec, bundles.pnt
    v = vec / torch.clamp(torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True)), min=1e-20)
    view_mask = (torch.arange(vec.shape[1], device=vec.device)[None, :]
                 < bundles.num_views[:, None])                           # (T, V)
    w = view_mask[..., None].to(v.dtype)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    tmp = (v[..., :, None] * v[..., None, :] - eye) * w[..., None]      # (T, V, 3, 3)
    S = torch.sum(tmp, dim=1)
    C = torch.sum(torch.sum(tmp * (pnt * w)[..., None, :], dim=-1), dim=1)

    ok = torch.abs(torch.linalg.det(S.detach())) > 1e-20
    S_safe = torch.where(ok[:, None, None], S, eye)
    # solve_ex: solve's arithmetic without its check of the singular
    # systems, which ``ok`` has taken out, and which waits for the card
    point = torch.linalg.solve_ex(S_safe, C[..., None])[0].squeeze(-1)
    point = torch.where(ok[:, None], point, 0.0)

    p1 = pnt
    p2 = pnt + v * 1000.0
    d = _cross(point[:, None, :] - p1, point[:, None, :] - p2)
    c = p2 - p1
    dist = (torch.sqrt(torch.sum(d * d, dim=-1))
            / torch.clamp(torch.sqrt(torch.sum(c * c, dim=-1)), min=1e-20))
    sq = (dist ** 2) * view_mask
    nv = torch.clamp(bundles.num_views.to(v.dtype), min=1.0)
    if reference_error_mode:
        last = torch.clamp(bundles.num_views - 1, min=0).to(torch.int64)
        err = torch.gather(sq, 1, last[:, None])[:, 0] / nv
    else:
        err = torch.sum(sq, dim=1) / nv
    valid = bundles.mask & ok
    err = torch.where(valid, err, 0.0)
    return PointCloud(points=point, errors=err, mask=valid), torch.sum(err)


def triangulate(bundles: Bundles, two_view: bool, cutoff: float = math.inf):
    """The pipeline's 2-view / N-view switch (``cutoff`` is 2-view only)."""
    if two_view:
        return two_view_triangulate(bundles, cutoff)
    return n_view_triangulate(bundles)


def triangulate_matches(matches, cameras, two_view: bool = True, cutoff: float = math.inf,
                        pushbrooms=None):
    """Bundle generation (pushbroom rays with ``pushbrooms``) + triangulation."""
    from ssrlcv_tpu_torch.geometry.bundles import generate_bundles

    return triangulate(generate_bundles(matches, cameras, pushbrooms=pushbrooms), two_view, cutoff)


def linear_error_objective(bundles: Bundles) -> torch.Tensor:
    """Differentiable total linear error: the 2-view BA objective."""
    l1_vec, l1_pnt, l2_vec, l2_pnt = _masked_safe_lines(bundles)
    s1, s2 = two_view_midpoints(l1_vec, l1_pnt, l2_vec, l2_pnt)
    err = torch.sum((s1 - s2) ** 2, dim=-1)
    return torch.sum(torch.where(bundles.mask, err, 0.0))
