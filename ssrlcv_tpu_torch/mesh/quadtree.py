"""2-D quadtree over localized data.

Counterpart of ``ssrlcv_tpu/mesh/quadtree.py``: a generic 2-D spatial index
over data items with (x, y) locations, as a sorted 2-D Morton ordering
(int64 keys with the JAX package's uint32 values) with the octree's
windowed neighbourhood query.  No pipeline stage uses it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ssrlcv_tpu_torch.core.device import as_device_tensor
from ssrlcv_tpu_torch.mesh.octree import INVALID_KEY, _smallest_k, _sqrt


def _expand_bits_2d(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits with one zero bit between each."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_keys_2d(locs: torch.Tensor, bbox_min: torch.Tensor, bbox_max: torch.Tensor,
                   depth: int) -> torch.Tensor:
    extent = torch.clamp(bbox_max - bbox_min, min=1e-12)
    scale = torch.full_like(extent, float(2 ** depth)) / extent
    g = ((locs - bbox_min) * scale).to(torch.int64)
    g = torch.clamp(g, 0, 2 ** depth - 1)
    return _expand_bits_2d(g[:, 0]) | (_expand_bits_2d(g[:, 1]) << 1)


class Quadtree(NamedTuple):
    locs: torch.Tensor     # (N, 2) sorted by Morton key
    keys: torch.Tensor     # (N,) int64
    order: torch.Tensor    # (N,) int32 original indices
    mask: torch.Tensor     # (N,)
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    depth: int


def build_quadtree(locs, mask, depth: int = 10, device=None) -> Quadtree:
    """Sorted 2-D Morton structure on ``device`` (None: the device of a
    tensor ``locs``, else ``cuda:0``); invalid items sort to the end."""
    locs = as_device_tensor(locs, device).to(torch.float32)
    mask = as_device_tensor(mask, locs.device).to(torch.bool)
    bbox_min = torch.amin(torch.where(mask[:, None], locs, torch.inf), dim=0)
    bbox_max = torch.amax(torch.where(mask[:, None], locs, -torch.inf), dim=0)
    keys = torch.where(mask, morton_keys_2d(locs, bbox_min, bbox_max, depth), INVALID_KEY)
    keys, order = torch.sort(keys, stable=True)
    return Quadtree(locs=locs[order], keys=keys, order=order.to(torch.int32), mask=mask[order],
                    bbox_min=bbox_min, bbox_max=bbox_max, depth=depth)


def knn_2d(tree: Quadtree, k: int = 8, window: int = 32):
    """Windowed kNN in Morton order: (idx (N, k) int32 into the sorted
    order, dist (N, k))."""
    n = tree.locs.shape[0]
    dev = tree.locs.device
    offs = torch.arange(-window, window + 1, device=dev)
    raw = torch.arange(n, device=dev)[:, None] + offs[None, :]
    in_range = (raw >= 0) & (raw < n)
    idx = torch.clamp(raw, 0, n - 1)
    diff = tree.locs[idx] - tree.locs[:, None, :]
    d = _sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    valid = in_range & tree.mask[idx] & tree.mask[:, None] & (offs[None, :] != 0)
    d, col = _smallest_k(torch.where(valid, d, torch.inf), k)
    return torch.gather(idx, 1, col).to(torch.int32), d


def node_counts_2d(tree: Quadtree, depth: int) -> int:
    """Unique occupied nodes at a coarser depth."""
    shift = 2 * (tree.depth - depth)
    keys = tree.keys[tree.mask].cpu().numpy()
    return int(np.unique(keys >> shift).size)
