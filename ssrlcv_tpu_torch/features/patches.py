"""K5: per-keypoint aligned gradient patches (wrapper, plain version).

Counterpart of ``ssrlcv_tpu/features/patches.py`` (the Pallas kernel
``_extract_kernel``).  For each keypoint an aligned (SPA, LW) window of both
gradient planes is copied out, and the orientation and descriptor passes then
sample inside the patch (``sample_in_patches``) instead of indexing the
plane: the ``use_patches=True`` route of ``orientation.compute_orientations``
and ``descriptor.fill_descriptors``.  For coordinates inside the patch (every
coordinate of an in-window keypoint) the samples are bit-identical to
indexing the plane.

The window origin keeps the JAX function's contract exactly, because
``sample_in_patches`` depends on it: with (cx, cy) the keypoint location
rounded half to even,

    y0 = clip((cy - (w_max + 1)) & ~7,  0, H - SPA)
    x0 = clip((cx - 64) & ~127,        0, W - LW)

(two's-complement ``&`` on negative values).  The row and lane alignment are
the TPU's DMA tile rules; they are kept because they are part of the output.

The CUDA kernel is ``csrc/patches.cu``; ``extract_patches`` takes the plain
version ``extract_patches_plain`` only for tensors on the CPU, and on a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu_torch import _cuda

LW = 256  # patch lanes: covers any window of half-width <= 63 after the 128-lane alignment


def patch_rows(w_max: int) -> int:
    """Patch height: a +-(w_max+1) window plus up to 7 rows of alignment
    slack, rounded up to a multiple of 8."""
    return ((2 * (w_max + 1) + 1 + 7 + 7) // 8) * 8


def patches_supported(h: int, w: int, w_max: int) -> bool:
    """The plane holds at least one patch and the window fits the patch."""
    return h >= patch_rows(w_max) and w >= LW and w_max + 1 <= LW // 4


def patch_origins(loc: torch.Tensor, h: int, w: int, w_max: int):
    """(y0, x0) int32 patch origins of keypoints ``loc`` (K, 2)."""
    cx = torch.round(loc[:, 0]).to(torch.int32)
    cy = torch.round(loc[:, 1]).to(torch.int32)
    y0 = torch.clamp((cy - (w_max + 1)) & ~7, 0, h - patch_rows(w_max))
    x0 = torch.clamp((cx - 64) & ~127, 0, w - LW)
    return y0, x0


def extract_patches_plain(gx, gy, loc, w_max: int):
    """(px, py, y0, x0): px[k] = gx[y0[k]:y0[k]+SPA, x0[k]:x0[k]+LW], py
    likewise, by indexing the planes."""
    h, w = gx.shape
    spa = patch_rows(w_max)
    y0, x0 = patch_origins(loc, h, w, w_max)
    rows = (y0.to(torch.int64)[:, None] + torch.arange(spa, device=gx.device))[:, :, None]
    cols = (x0.to(torch.int64)[:, None] + torch.arange(LW, device=gx.device))[:, None, :]
    return gx[rows, cols], gy[rows, cols], y0, x0


def sample_in_patches(px, py, y0, x0, yi, xi):
    """Sample patches at plane coordinates (yi, xi): bit-identical to
    ``gx[yi, xi]`` for coordinates inside the patch; others clip to the
    patch's edge (border keypoints, masked downstream).

    px, py: (K, SPA, LW); yi, xi: (K, ...) integer, mutually broadcastable.
    Returns (g_x, g_y), each shaped like the broadcast of yi and xi."""
    yi, xi = torch.broadcast_tensors(yi, xi)
    k, spa, lw = px.shape
    lead = (k,) + (1,) * (yi.dim() - 1)
    ri = torch.clamp(yi - y0.reshape(lead), 0, spa - 1)
    ci = torch.clamp(xi - x0.reshape(lead), 0, lw - 1)
    idx = (ri.to(torch.int64) * lw + ci).reshape(k, -1)
    g_x = torch.take_along_dim(px.reshape(k, spa * lw), idx, dim=1)
    g_y = torch.take_along_dim(py.reshape(k, spa * lw), idx, dim=1)
    return g_x.reshape(yi.shape), g_y.reshape(yi.shape)


def plane_sampler(gx, gy):
    """The direct sampler: ``sample(sl, yi, xi)`` indexes the planes at
    (yi, xi), already clipped to the plane, for keypoints ``sl``."""

    def sample(sl, yi, xi):
        return gx[yi, xi], gy[yi, xi]

    return sample


def patch_sampler(gx, gy, loc, w_max: int):
    """The in-patch sampler of keypoints ``loc`` over the planes: extracts
    their patches (K5) and returns ``sample(sl, yi, xi)``, which samples the
    patches of keypoints ``sl`` at plane coordinates (yi, xi)."""
    px, py, y0, x0 = extract_patches(gx, gy, loc.contiguous(), w_max)

    def sample(sl, yi, xi):
        return sample_in_patches(px[sl], py[sl], y0[sl], x0[sl], yi, xi)

    return sample


def _check(gx, gy, loc, w_max: int):
    if gx.dim() != 2 or gx.shape != gy.shape:
        raise ValueError(f"gx, gy must be equal (H, W) planes, got {tuple(gx.shape)}, "
                         f"{tuple(gy.shape)}")
    if loc.dim() != 2 or loc.shape[1] != 2:
        raise ValueError(f"loc must be (K, 2), got {tuple(loc.shape)}")
    for name, t in (("gx", gx), ("gy", gy), ("loc", loc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != gx.device:
            raise ValueError(f"{name} is on {t.device}, gx on {gx.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    h, w = gx.shape
    if not patches_supported(h, w, w_max):
        raise ValueError(f"patches of w_max={w_max} need a plane of at least "
                         f"{patch_rows(w_max)} x {LW} and w_max <= {LW // 4 - 1}; "
                         f"got {h} x {w}")


def extract_patches(gx, gy, loc, w_max: int):
    """Per-keypoint aligned gradient patches.

    gx, gy (H, W) float32 planes, loc (K, 2) float32 (x, y) plane coordinates
    -> px, py (K, SPA, LW) float32, y0, x0 (K,) int32, with SPA =
    ``patch_rows(w_max)``.  CPU tensors take the plain version; CUDA tensors
    the K5 kernel."""
    _check(gx, gy, loc, w_max)
    if gx.device.type == "cpu":
        return extract_patches_plain(gx, gy, loc, w_max)
    if gx.device.type != "cuda":
        raise ValueError(f"extract_patches: unsupported device {gx.device}")
    h, w = gx.shape
    k = loc.shape[0]
    spa = patch_rows(w_max)
    px = torch.empty((k, spa, LW), dtype=torch.float32, device=gx.device)
    py = torch.empty_like(px)
    y0 = torch.empty((k,), dtype=torch.int32, device=gx.device)
    x0 = torch.empty_like(y0)
    if k == 0:
        return px, py, y0, x0
    vec = int(w % 4 == 0 and gx.data_ptr() % 16 == 0 and gy.data_ptr() % 16 == 0)
    rc = _cuda.library().ssrlcv_extract_patches(
        gx.data_ptr(), gy.data_ptr(), h, w, loc.data_ptr(), k, w_max, spa, vec,
        px.data_ptr(), py.data_ptr(), y0.data_ptr(), x0.data_ptr(),
        _cuda.stream_ptr(gx.device))
    _cuda.check(rc, "ssrlcv_extract_patches")
    extract_patches.launches += 1
    return px, py, y0, x0


extract_patches.launches = 0
