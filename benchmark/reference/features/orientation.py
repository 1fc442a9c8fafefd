"""Keypoint orientation assignment.

Counterpart of ``ssrlcv_tpu/features/orientation.py``: a 36-bin
gradient-orientation histogram per keypoint (kernel K1,
``orient_kernel.orientation_histograms``, plain here), parabola-interpolated
circular peaks, and up to ``max_orientations`` oriented copies per keypoint.
Gradients are those of one normalised DoG slice (one blur bucket).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.config import SIFTParams
from benchmark.reference.features.detector import SSKeyPoints
from benchmark.reference.features.orient_kernel import orientation_histograms


def _histogram_for_keypoints(gx, gy, loc, sigma, mask, pixel_width: float,
                             lambda_o: float, w_max: int):
    """(K, 36) weighted orientation histograms of one gradient plane (zero
    for masked keypoints), plus the border-validity flag (window inside the
    image)."""
    h, w = gx.shape
    win = torch.ceil(sigma * 3.0 * lambda_o / pixel_width)
    inside = ((loc[:, 0] - win >= 0.0) & (loc[:, 1] - win >= 0.0)
              & (loc[:, 0] + win < w - 1) & (loc[:, 1] + win < h - 1))
    hist = orientation_histograms(gx, gy, loc.contiguous(), sigma.contiguous(),
                                  float(pixel_width), w_max, float(lambda_o))
    return torch.where(mask[:, None], hist, 0.0), mask & inside


def peaks_from_histograms(hist: torch.Tensor, valid: torch.Tensor, params: SIFTParams):
    """Peak finding and parabola interpolation over (K, 36) histograms.
    Returns (top_theta, top_ok), each (K, max_orientations), thetas in
    descending histogram magnitude; equal magnitudes keep the lower bin
    first (a stable descending sort, as jax.lax.top_k)."""
    prev = torch.roll(hist, 1, dims=1)
    nxt = torch.roll(hist, -1, dims=1)
    maxh = torch.amax(hist, dim=1, keepdim=True) * params.orientation_threshold
    is_peak = (hist >= maxh) & (hist >= prev) & (hist >= nxt)

    denom = prev - 2.0 * hist + nxt
    off = torch.where(torch.abs(denom) > 0, (prev - nxt) / denom, 0.0)
    bcenters = torch.arange(36, dtype=hist.dtype, device=hist.device) * (math.pi / 18.0)
    theta = torch.remainder(off * (math.pi / 36.0) + bcenters[None, :] + 2.0 * math.pi,
                            2.0 * math.pi)

    mags = torch.where(is_peak, hist, -torch.inf)
    m = params.max_orientations
    top_mags, top_idx = torch.sort(mags, dim=1, descending=True, stable=True)
    top_mags, top_idx = top_mags[:, :m], top_idx[:, :m]
    top_theta = torch.gather(theta, 1, top_idx)
    top_ok = (top_mags > 0.0) & torch.isfinite(top_mags) & valid[:, None]
    return top_theta, top_ok


def compute_orientations(gx, gy, kps: SSKeyPoints, pixel_width: float,
                         params: SIFTParams, w_max: int) -> SSKeyPoints:
    """Expand keypoints to ``max_orientations`` oriented copies each (masked
    where no peak), ordered (kp0 t0, kp0 t1, kp1 t0, ...) with thetas per
    keypoint in descending histogram magnitude.  ``w_max`` bounds the
    window half-width of every keypoint given (``sift._bucket_windows``)."""
    hist, valid = _histogram_for_keypoints(
        gx, gy, kps.loc, kps.sigma, kps.mask, pixel_width,
        params.orientation_contrib_width, w_max)
    thetas, ok = peaks_from_histograms(hist, valid, params)
    m = params.max_orientations

    def rep(x):
        return torch.repeat_interleave(x, m, dim=0)

    return SSKeyPoints(
        blur=rep(kps.blur), loc=rep(kps.loc), intensity=rep(kps.intensity),
        sigma=rep(kps.sigma), theta=thetas.reshape(-1), mask=ok.reshape(-1))
