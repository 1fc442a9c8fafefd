"""Image-space primitives for the scale-space front end.

Counterpart of ``ssrlcv_tpu/ops/image_ops.py``: float conversion, min-max
normalisation, 2x bin / bilinear upsample with symmetric borders, separable
Gaussian blur and central-difference gradients, on (H, W) float32 maps.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def to_float(pixels: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32, value-preserving 0..255 (no /255 scaling)."""
    return pixels.to(torch.float32)


def to_bw(pixels: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W): RGB mixes r/4 + g/2 + b/4 in integer math."""
    if pixels.ndim == 2:
        return pixels
    c = pixels.shape[-1]
    if c in (3, 4):
        p = pixels.to(torch.int32)
        return (p[..., 0] // 4 + p[..., 1] // 2 + p[..., 2] // 4).to(torch.uint8)
    return pixels[..., 0]


def normalize_minmax(img: torch.Tensor) -> torch.Tensor:
    """Min-max normalise to [0, 1]."""
    lo = torch.min(img)
    hi = torch.max(img)
    return (img - lo) / (hi - lo)


def bin2x(img: torch.Tensor) -> torch.Tensor:
    """2x downsample by 2x2 averaging."""
    h, w = img.shape
    r = img.reshape(h // 2, 2, w // 2, 2)
    # pairwise sum then /4: the order XLA's compiled mean takes at the
    # pyramid's power-of-two shapes
    return ((r[:, 0, :, 0] + r[:, 0, :, 1]) + (r[:, 1, :, 0] + r[:, 1, :, 1])) / 4.0


def _symmetrize_coords(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Symmetric (reflect-with-edge-repeat) coordinate wrap."""
    nn = 2 * n
    i = (idx + nn) % nn
    return torch.where(i > n - 1, nn - 1 - i, i)


def upsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample: output (i, j) samples the input at (i/2, j/2)
    with floor/floor+1 symmetric taps."""
    h, w = img.shape
    dev = img.device
    x = torch.arange(2 * w, device=dev, dtype=torch.int32) * 0.5
    y = torch.arange(2 * h, device=dev, dtype=torch.int32) * 0.5
    xm = _symmetrize_coords(x.to(torch.int64), w)
    xp = _symmetrize_coords(x.to(torch.int64) + 1, w)
    ym = _symmetrize_coords(y.to(torch.int64), h)
    yp = _symmetrize_coords(y.to(torch.int64) + 1, h)
    fx = (x - torch.floor(x))[None, :]
    fy = (y - torch.floor(y))[:, None]
    p_mm = img[ym][:, xm]
    p_mp = img[ym][:, xp]
    p_pm = img[yp][:, xm]
    p_pp = img[yp][:, xp]
    return (
        fx * fy * p_pp
        + (1 - fx) * fy * p_pm
        + fx * (1 - fy) * p_mp
        + (1 - fx) * (1 - fy) * p_mm
    )


def gaussian_kernel_1d(sigma: float, pixel_width: float, base_size: int = 8) -> np.ndarray:
    """The reference blur taps: count ceil(base*sigma/pixel_width) bumped to
    odd; taps are the unnormalised continuous Gaussian sampled at integers.
    Host computation (sizes are static)."""
    k = int(math.ceil(base_size * sigma / pixel_width))
    if k % 2 == 0:
        k += 1
    half = k // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    taps = np.exp(-(x * x) / 2.0 / sigma / sigma) / math.sqrt(2.0 * math.pi) / sigma
    return taps.astype(np.float32)


def _fma_taps(pad: torch.Tensor, taps: np.ndarray, axis: int, n: int) -> torch.Tensor:
    """sum_t tap_t * pad[t : t+n] along ``axis``, accumulated tap by tap in
    float32 with each step a fused multiply-add (one rounding): the float64
    sum of an exact float32 x float32 product and the float32 accumulator,
    rounded back to float32."""
    pad64 = pad.to(torch.float64)
    acc = torch.zeros_like(pad.narrow(axis, 0, n))
    for t, tap in enumerate(taps):
        acc = torch.add(acc.to(torch.float64), pad64.narrow(axis, t, n),
                        alpha=float(tap)).to(torch.float32)
    return acc


def convolve_separable_symmetric(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable 2-D convolution with symmetric border.  The kernel is
    symmetric, so convolution == correlation.

    Written as shifted multiply-adds in the JAX package's tap order, and not
    as ``conv2d``: cuDNN would run float32 convolutions in TF32 by default
    and sum in another order.  Each tap is one fused multiply-add, the form
    XLA compiles the JAX loop into, so the blurred planes equal the JAX
    package's bit for bit on the CPU."""
    half = len(taps) // 2
    h, w = img.shape
    dev = img.device
    cols = _symmetrize_coords(torch.arange(-half, w + half, device=dev), w)
    x = _fma_taps(img[:, cols], taps, 1, w)
    rows = _symmetrize_coords(torch.arange(-half, h + half, device=dev), h)
    return _fma_taps(x[rows, :], taps, 0, h)


def pixel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients of (..., H, W) maps, with the whole
    stencil shifted inward at the borders (x=0 uses p[2]-p[0], x=W-1 uses
    p[W-1]-p[W-3]).  Returns (gx, gy), each (..., H, W) and contiguous, the
    planes the orientation and descriptor kernels read."""
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device

    def taps(n):
        i = torch.arange(n, device=dev)
        ip = torch.where(i == 0, 2, torch.where(i == n - 1, n - 1, i + 1))
        im = torch.where(i == 0, 0, torch.where(i == n - 1, n - 3, i - 1))
        return ip, im

    xp, xm = taps(w)
    yp, ym = taps(h)
    gx = img[..., :, xp] - img[..., :, xm]
    gy = img[..., yp, :] - img[..., ym, :]
    return gx.contiguous(), gy.contiguous()


def make_binnable_shape(h: int, w: int, planned_depth: int) -> tuple[int, int, tuple[int, int]]:
    """Padded shape for binning to ``planned_depth``: (H', W', border)."""
    num_resize = 2 ** planned_depth
    bh = 0 if h % num_resize == 0 else (num_resize - h % num_resize) // 2
    bw = 0 if w % num_resize == 0 else (num_resize - w % num_resize) // 2
    return h + 2 * bh, w + 2 * bw, (bh, bw)


def add_buffer_border(img: torch.Tensor, border: tuple[int, int]) -> torch.Tensor:
    """Zero border padding."""
    bh, bw = border
    return torch.nn.functional.pad(img, (bw, bw, bh, bh))
