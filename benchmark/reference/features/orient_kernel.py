"""K1: orientation histograms of one gradient plane (wrapper, plain version).

Replaces the Pallas kernel ``ssrlcv_tpu/features/orient_kernel.py``
(``_orient_kernel``).  The CUDA kernel is ``csrc/orient.cu``; its plain
PyTorch twin is ``orientation_histograms_plain``, the gather form of
``ssrlcv_tpu/features/orientation.py::_histogram_for_keypoints``.

In this frozen copy ``orientation_histograms`` takes the plain version on
every device.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.features.patches import plane_sampler

TWO_PI = 2.0 * math.pi
INV_RAD10 = 18.0 / math.pi  # bin = floor(angle * 18/pi): a product on every device


def window_and_denom(sigma: torch.Tensor, pixel_width: float, lambda_o: float):
    """Per-keypoint window half-width ceil(3*lambda*sigma/pw) and Gaussian
    denominator 2*lambda^2*sigma^2, each operation rounded to float32 (the
    kernel computes the same per keypoint)."""
    win = torch.ceil(sigma * 3.0 * lambda_o / pixel_width)
    denom = 2.0 * lambda_o * lambda_o * sigma * sigma
    return win.contiguous(), denom.contiguous()


def _window_terms(gx, gy, loc, sigma, pixel_width: float, w_max: int, lambda_o: float,
                  sample=None):
    """Per keypoint and offset of the (2*w_max+1)^2 grid (rows dy, columns
    dx): the weight, masked to the keypoint's own window, and the bin; and
    the windows."""
    h, w = gx.shape
    win, denom = window_and_denom(sigma, pixel_width, lambda_o)
    dev = gx.device
    offs = torch.arange(2 * w_max + 1, device=dev, dtype=torch.float32) - w_max
    dx = offs[None, :]
    dy = offs[:, None]
    in_win = (torch.abs(dx) <= win[:, None, None]) & (torch.abs(dy) <= win[:, None, None])
    cx = torch.round(loc[:, 0]).to(torch.int64)
    cy = torch.round(loc[:, 1]).to(torch.int64)
    oi = offs.to(torch.int64)
    xi = torch.clamp(cx[:, None, None] + oi[None, None, :], 0, w - 1)
    yi = torch.clamp(cy[:, None, None] + oi[None, :, None], 0, h - 1)
    g_x, g_y = (sample or plane_sampler(gx, gy))(slice(None), yi, xi)
    mag = torch.sqrt(g_x * g_x + g_y * g_y)
    wgt = mag * torch.exp(-(dx * dx + dy * dy)[None] / denom[:, None, None])
    wgt = torch.where(in_win, wgt, 0.0)
    ang = torch.remainder(torch.atan2(g_y, g_x) + TWO_PI, TWO_PI)
    bins = torch.clamp(torch.floor(ang * INV_RAD10), 0, 35).to(torch.int64)
    return wgt, bins, win


def orientation_histograms_plain(gx, gy, loc, sigma, pixel_width: float, w_max: int,
                                 lambda_o: float, sample=None) -> torch.Tensor:
    """(K, 36) float32 weighted orientation histograms by sampling the
    (2*w_max+1)^2 grid around each keypoint, masked to its own window.

    ``sample(sl, yi, xi)`` reads the gradients at plane coordinates: by
    default the planes themselves (``patches.plane_sampler``); the
    ``use_patches`` route passes ``patches.patch_sampler``."""
    wgt, bins, _ = _window_terms(gx, gy, loc, sigma, pixel_width, w_max, lambda_o, sample)
    return torch.stack(
        [torch.where(bins == b, wgt, 0.0).sum(dim=(1, 2)) for b in range(36)], dim=1)


def orientation_histograms_lanes(gx, gy, loc, sigma, pixel_width: float, w_max: int,
                                 lambda_o: float) -> torch.Tensor:
    """``orientation_histograms_plain`` summed in K1's order: lane l of a
    keypoint's warp adds samples l, l+32, ... of its window (row-major over
    the (2r+1)^2 offsets, r = min(win, w_max)) into its own histogram, in
    that order; then bin b is the sum over lanes j, j+1, ..., j+31 (mod 32),
    j = b mod 18, in that order.  Every addition is one float32 rounding, as
    in the kernel."""
    wgt, bins, win = _window_terms(gx, gy, loc, sigma, pixel_width, w_max, lambda_o)
    k = loc.shape[0]
    r = torch.where(win >= 0, torch.clamp(win, max=w_max), -1.0).to(torch.int64)
    lanes = torch.zeros((k, 32, 36), dtype=torch.float32, device=gx.device)
    for rv in r.unique().tolist():
        if rv < 0:
            continue  # a NaN or negative window adds nothing
        sel = torch.nonzero(r == rv).squeeze(1)
        n = (2 * rv + 1) ** 2
        win_sl = slice(w_max - rv, w_max + rv + 1)
        wg = wgt[sel][:, win_sl, win_sl].reshape(-1, n)
        bn = bins[sel][:, win_sl, win_sl].reshape(-1, n)
        acc = torch.zeros((sel.shape[0], 32, 36), dtype=torch.float32, device=gx.device)
        rows = torch.arange(sel.shape[0], device=gx.device)[:, None]
        for s0 in range(0, n, 32):
            s = torch.arange(s0, min(s0 + 32, n), device=gx.device)
            acc[rows, (s - s0)[None, :], bn[:, s]] += wg[:, s]
        lanes[sel] = acc
    b = torch.arange(36, device=gx.device)
    out = torch.zeros((k, 36), dtype=torch.float32, device=gx.device)
    for t in range(32):
        out = out + lanes[:, (b % 18 + t) % 32, b]
    return out


def _check(gx, gy, loc, sigma):
    if gx.dim() != 2 or gx.shape != gy.shape:
        raise ValueError(f"gx, gy must be equal (H, W) planes, got {tuple(gx.shape)}, "
                         f"{tuple(gy.shape)}")
    k = loc.shape[0]
    if loc.shape != (k, 2) or sigma.shape != (k,):
        raise ValueError(f"loc must be (K, 2) and sigma (K,), got {tuple(loc.shape)}, "
                         f"{tuple(sigma.shape)}")
    for name, t in (("gx", gx), ("gy", gy), ("loc", loc), ("sigma", sigma)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != gx.device:
            raise ValueError(f"{name} is on {t.device}, gx on {gx.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def orientation_histograms(gx, gy, loc, sigma, pixel_width: float, w_max: int,
                           lambda_o: float) -> torch.Tensor:
    """(K, 36) float32 orientation histograms: the plain version on every
    device."""
    _check(gx, gy, loc, sigma)
    return orientation_histograms_plain(gx, gy, loc, sigma, pixel_width, w_max, lambda_o)
