"""FAST corner detector.

Counterpart of ``ssrlcv_tpu/features/fast.py``.  FAST-N (Rosten and
Drummond 2006): a pixel p is a corner when at least N contiguous pixels of
the 16-pixel Bresenham circle of radius 3 are all brighter than p + t or
all darker than p - t.  The detector is 16 static shifts, elementwise logic
and a 3x3 non-maximum suppression, then the strongest ``capacity`` corners.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu_torch.core.device import as_device_tensor

# the 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock, (dy, dx)
_CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
           (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def _has_arc(flags: torch.Tensor, arc_length: int) -> torch.Tensor:
    """(H, W, 16) bool -> (H, W): some ``arc_length`` circle pixels in a row
    (wrapping around) are all set."""
    wrapped = torch.cat([flags, flags[..., :arc_length - 1]], dim=-1)
    return wrapped.unfold(-1, arc_length, 1).all(dim=-1).any(dim=-1)


def detect_fast(img, threshold: float = 20.0, arc_length: int = 9, capacity: int = 4096,
                device=None):
    """FAST corners of a grayscale (H, W) image on ``device`` (when None: the
    device of a tensor ``img``, else ``cuda:0``, which raises without a
    card).  The score is the sum of |d| - t over the circle pixels with
    |d| > t; of equal neighbours under non-maximum suppression the one first
    in raster order survives.

    Returns (locs (capacity, 2) float32 (x, y), scores (capacity,), mask
    (capacity,)) in descending score, equal scores in raster order; rows
    past the corners found are zero and masked."""
    img = as_device_tensor(img, device).to(torch.float32)
    h, w = img.shape
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) for dy, dx in _CIRCLE], dim=-1)
    d = ring - img[..., None]
    is_corner = _has_arc(d > threshold, arc_length) | _has_arc(d < -threshold, arc_length)
    score = torch.sum(torch.where(torch.abs(d) > threshold, torch.abs(d) - threshold, 0.0), dim=-1)
    score = torch.where(is_corner, score, 0.0)

    keep = is_corner & (score > 0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            # the neighbour at offset (-dy, -dx); it precedes p in raster
            # order when -dy < 0, or -dy == 0 and -dx < 0
            shifted = torch.roll(score, (dy, dx), dims=(0, 1))
            precedes = (-dy < 0) or (dy == 0 and -dx < 0)
            keep = keep & ((score > shifted) if precedes else (score >= shifted))
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    keep = keep & (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)

    flat = torch.where(keep, score, -1.0).reshape(-1)
    k = min(capacity, h * w)
    # a stable descending sort: equal scores keep the lower flat index first
    top_score, top_idx = torch.sort(flat, descending=True, stable=True)
    top_score, top_idx = top_score[:k], top_idx[:k]
    if k < capacity:  # pad back to the requested capacity
        top_score = torch.cat([top_score, top_score.new_full((capacity - k,), -1.0)])
        top_idx = torch.cat([top_idx, top_idx.new_zeros(capacity - k)])
    mask = top_score > 0
    locs = torch.stack([(top_idx % w).to(torch.float32),
                        torch.div(top_idx, w, rounding_mode="floor").to(torch.float32)], dim=-1)
    return torch.where(mask[:, None], locs, 0.0), torch.where(mask, top_score, 0.0), mask
