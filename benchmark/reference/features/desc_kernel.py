"""K2: raw SIFT descriptor histograms of one gradient plane (wrapper, plain).

Replaces the Pallas kernel ``ssrlcv_tpu/features/desc_kernel.py``
(``_desc_kernel``).  The CUDA kernel is ``csrc/desc.cu``; its plain PyTorch
twin is ``descriptor_histograms_plain``, the gather form of
``ssrlcv_tpu/features/descriptor.py::fill_descriptors`` before the epilogue.

In this frozen copy ``descriptor_histograms`` takes the plain version on
every device.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.features.patches import plane_sampler

TWO_PI = 2.0 * math.pi
RAD45 = math.pi / 4.0
INV_RAD45 = 4.0 / math.pi  # angular weight 1 - d*(4/pi): a product on every device
# 4x4 cell centres in window units, flattened c = ny*4 + nx
_NX = [0.5 * i - 0.75 for i in range(4)]
_CELL_X = [_NX[c % 4] for c in range(16)]
_CELL_Y = [_NX[c // 4] for c in range(16)]


def descriptor_window(sigma: torch.Tensor, pixel_width: float, lambda_d: float) -> torch.Tensor:
    """Per-keypoint descriptor window ceil(sigma*lambda/pw)."""
    return torch.ceil(sigma * lambda_d / pixel_width).contiguous()


def descriptor_histograms_plain(gx, gy, loc, theta, sigma, pixel_width: float,
                                lambda_d: float, w_max: int, chunk: int = 512,
                                sample=None) -> torch.Tensor:
    """(K, 128) float32 raw histograms by sampling the rotated
    (2*w_max+1)^2 lattice of each keypoint, ``chunk`` keypoints at a time.

    ``sample(sl, yi, xi)`` reads the gradients of keypoints ``sl`` at plane
    coordinates: by default the planes themselves
    (``patches.plane_sampler``); the ``use_patches`` route passes
    ``patches.patch_sampler``."""
    h, w = gx.shape
    dev = gx.device
    sample = sample or plane_sampler(gx, gy)
    offs = torch.arange(2 * w_max + 1, device=dev, dtype=torch.float32) - w_max
    dy_g, dx_g = torch.meshgrid(offs, offs, indexing="ij")
    dx = dx_g.reshape(-1)
    dy = dy_g.reshape(-1)
    cell_x = torch.tensor(_CELL_X, device=dev, dtype=torch.float32)
    cell_y = torch.tensor(_CELL_Y, device=dev, dtype=torch.float32)
    kk = torch.arange(8, device=dev, dtype=torch.float32) * RAD45
    win_all = descriptor_window(sigma, pixel_width, lambda_d)
    ct_all, st_all = torch.cos(theta), torch.sin(theta)
    out = []
    for s0 in range(0, loc.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        lc, th, win = loc[sl], theta[sl], win_all[sl]
        ct, st = ct_all[sl, None], st_all[sl, None]
        cxs = dx[None, :] * ct - dy[None, :] * st
        cys = dx[None, :] * st + dy[None, :] * ct
        wc = win[:, None]
        valid_s = ((torch.abs(dx)[None, :] <= wc) & (torch.abs(dy)[None, :] <= wc)
                   & (torch.abs(cxs) <= wc) & (torch.abs(cys) <= wc))
        xi = torch.clamp(torch.round(cxs + lc[:, 0:1]).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.round(cys + lc[:, 1:2]).to(torch.int64), 0, h - 1)
        g_x, g_y = sample(sl, yi, xi)
        mag = torch.sqrt(g_x * g_x + g_y * g_y)
        wgt = mag * torch.exp(-(cxs * cxs + cys * cys) / (2.0 * (wc * wc)))
        ang = torch.fmod(torch.atan2(g_y, g_x) - th[:, None] + TWO_PI, TWO_PI)
        wgt = torch.where(valid_s, wgt, 0.0)

        hx0 = cell_x[None, :] * wc
        hy0 = cell_y[None, :] * wc
        hx = hx0 * ct - hy0 * st
        hy = hx0 * st + hy0 * ct
        binw = (win / 2.0)[:, None, None]
        ddx = torch.abs(hx[:, None, :] - cxs[:, :, None])  # (C, S2, 16)
        ddy = torch.abs(hy[:, None, :] - cys[:, :, None])
        in_cell = (ddx <= binw) & (ddy <= binw)
        spatial = torch.where(in_cell, (1.0 - ddx / binw) * (1.0 - ddy / binw), 0.0)
        spatial = spatial * wgt[:, :, None]
        adist = torch.abs(ang[:, :, None] - kk[None, None, :])  # (C, S2, 8)
        wang = torch.where(adist < RAD45, 1.0 - adist * INV_RAD45, 0.0)
        hist = torch.einsum("scb,sck->sbk", spatial, wang)
        out.append(hist.reshape(hist.shape[0], 128))
    if not out:
        return torch.zeros((0, 128), dtype=torch.float32, device=dev)
    return torch.cat(out)


def _check(gx, gy, loc, theta, sigma):
    if gx.dim() != 2 or gx.shape != gy.shape:
        raise ValueError(f"gx, gy must be equal (H, W) planes, got {tuple(gx.shape)}, "
                         f"{tuple(gy.shape)}")
    k = loc.shape[0]
    if loc.shape != (k, 2) or theta.shape != (k,) or sigma.shape != (k,):
        raise ValueError(f"loc must be (K, 2), theta and sigma (K,), got {tuple(loc.shape)}, "
                         f"{tuple(theta.shape)}, {tuple(sigma.shape)}")
    for name, t in (("gx", gx), ("gy", gy), ("loc", loc), ("theta", theta), ("sigma", sigma)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != gx.device:
            raise ValueError(f"{name} is on {t.device}, gx on {gx.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def descriptor_histograms(gx, gy, loc, theta, sigma, pixel_width: float, lambda_d: float,
                          w_max: int) -> torch.Tensor:
    """(K, 128) float32 raw descriptor histograms: the plain version on
    every device."""
    _check(gx, gy, loc, theta, sigma)
    return descriptor_histograms_plain(gx, gy, loc, theta, sigma, pixel_width, lambda_d, w_max)
