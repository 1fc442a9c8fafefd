"""K1: orientation histograms of one gradient plane (wrapper, plain version).

Replaces the Pallas kernel ``ssrlcv_tpu/features/orient_kernel.py``
(``_orient_kernel``).  The CUDA kernel is ``csrc/orient.cu``; its plain
PyTorch twin is ``orientation_histograms_plain``, the gather form of
``ssrlcv_tpu/features/orientation.py::_histogram_for_keypoints``.

``orientation_histograms`` takes the plain version only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from ssrlcv_tpu_torch import _cuda
from ssrlcv_tpu_torch.features.patches import plane_sampler

TWO_PI = 2.0 * math.pi
INV_RAD10 = 18.0 / math.pi  # bin = floor(angle * 18/pi): a product on every device


def window_and_denom(sigma: torch.Tensor, pixel_width: float, lambda_o: float):
    """Per-keypoint window half-width ceil(3*lambda*sigma/pw) and Gaussian
    denominator 2*lambda^2*sigma^2 (the kernel and the plain version share
    these tensors)."""
    win = torch.ceil(sigma * 3.0 * lambda_o / pixel_width)
    denom = 2.0 * lambda_o * lambda_o * sigma * sigma
    return win.contiguous(), denom.contiguous()


def orientation_histograms_plain(gx, gy, loc, sigma, pixel_width: float, w_max: int,
                                 lambda_o: float, sample=None) -> torch.Tensor:
    """(K, 36) float32 weighted orientation histograms by sampling the
    (2*w_max+1)^2 grid around each keypoint, masked to its own window.

    ``sample(sl, yi, xi)`` reads the gradients at plane coordinates: by
    default the planes themselves (``patches.plane_sampler``); the
    ``use_patches`` route passes ``patches.patch_sampler``."""
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
    return torch.stack(
        [torch.where(bins == b, wgt, 0.0).sum(dim=(1, 2)) for b in range(36)], dim=1)


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
    """(K, 36) float32 orientation histograms of keypoints ``loc`` (K, 2)
    with scales ``sigma`` (K,) on one gradient plane ``gx``, ``gy`` (H, W).
    CPU tensors take the plain version; CUDA tensors the K1 kernel."""
    _check(gx, gy, loc, sigma)
    if gx.device.type == "cpu":
        return orientation_histograms_plain(gx, gy, loc, sigma, pixel_width, w_max, lambda_o)
    if gx.device.type != "cuda":
        raise ValueError(f"orientation_histograms: unsupported device {gx.device}")
    if not 0 <= w_max <= 48:
        raise ValueError(f"w_max must be in [0, 48], got {w_max}")
    h, w = gx.shape
    k = loc.shape[0]
    hist = torch.empty((k, 36), dtype=torch.float32, device=gx.device)
    if k == 0:
        return hist
    win, denom = window_and_denom(sigma, pixel_width, lambda_o)
    rc = _cuda.library().ssrlcv_orient_hist(
        gx.data_ptr(), gy.data_ptr(), h, w, loc.data_ptr(), win.data_ptr(),
        denom.data_ptr(), k, w_max, hist.data_ptr(), _cuda.stream_ptr(gx.device))
    _cuda.check(rc, "ssrlcv_orient_hist")
    orientation_histograms.launches += 1
    return hist


orientation_histograms.launches = 0
