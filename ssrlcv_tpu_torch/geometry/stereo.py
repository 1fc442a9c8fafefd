"""Dense stereo disparity.

Counterpart of ``ssrlcv_tpu/geometry/stereo.py``: window-SAD disparity as a
cost volume, one box-filtered absolute difference of the shifted image pair
per disparity over the whole image, then the first minimum over the
disparities (the reference's strict-< scan order); the depth formulas; and
the heat-map disparity image.

The absolute differences of uint8 pixels are integers, and so are their box
sums (below 31^2 * 255 < 2^24): they are summed in int32 and held exactly
in float32, so any summation order gives the same costs.
"""

from __future__ import annotations

import numpy as np
import torch

from ssrlcv_tpu_torch.core.device import as_device_tensor

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _offsets(max_disparity: int, direction: str) -> list:
    """The target-x offsets searched: 'right' (target x >= query x), 'left',
    or centred, starting at -max_disparity // 2, for any other direction."""
    if direction == "right":
        return list(range(0, max_disparity))
    if direction == "left":
        return list(range(0, -max_disparity, -1))
    return [o - max_disparity // 2 for o in range(max_disparity)]


def _box_sum(ad: torch.Tensor, window: int) -> torch.Tensor:
    """window x window sums of an (H, W) int32 map with zero padding, each
    centred on its pixel (reduce_window "SAME" for an odd window), as
    float32."""
    half = window // 2
    for dim in (0, 1):
        n = ad.shape[dim]
        pad = [0, 0, 0, 0]
        pad[2 * (1 - dim)], pad[2 * (1 - dim) + 1] = half + 1, half
        c = torch.cumsum(torch.nn.functional.pad(ad, pad), dim=dim, dtype=torch.int32)
        ad = c.narrow(dim, window, n) - c.narrow(dim, 0, n)
    return ad.to(torch.float32)


def _interior(h: int, w: int, half: int, device) -> torch.Tensor:
    """The query pixels whose window lies inside the image, less the last
    row and column (the reference's minimizedSize crop)."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (xs >= half) & (xs < w - half - 1) & (ys >= half) & (ys < h - half - 1)


def disparity_scan_matching(query: torch.Tensor, target: torch.Tensor, max_disparity: int = 64,
                            window: int = 11, direction: str = "right"):
    """Window-SAD scanline disparity of rectified (H, W) uint8 images.
    Returns (disparity (H, W) int32, the signed target-x offset; valid (H,
    W) bool)."""
    h, w = query.shape
    dev = query.device
    q = query.to(torch.int32)
    t = target.to(torch.int32)
    half = window // 2
    offsets = _offsets(max_disparity, direction)
    xs = torch.arange(w, device=dev)
    costs = []
    for o in offsets:
        cost = _box_sum(torch.abs(q - torch.roll(t, -o, dims=1)), window)
        # out-of-image target windows are invalid for this disparity
        in_img = (xs + o - half >= 0) & (xs + o + half < w)
        costs.append(torch.where(in_img[None, :], cost, torch.inf))
    costs = torch.stack(costs)
    best_cost, best = torch.min(costs, dim=0)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    return offs[best], torch.isfinite(best_cost) & _interior(h, w, half, dev)


def _floor_to_i32(v: torch.Tensor) -> torch.Tensor:
    """floor(v) as int32, saturated at the int32 range and 0 for NaN (the
    conversion XLA defines for values no int32 holds)."""
    f = torch.nan_to_num(torch.floor(v).to(torch.float64), nan=0.0)
    return torch.clamp(f, _I32_MIN, _I32_MAX).to(torch.int64).to(torch.int32)


def disparity_matching(query: torch.Tensor, target: torch.Tensor, fundamental: torch.Tensor,
                       max_disparity: int = 64, window: int = 11, direction: str = "right"):
    """Window-SAD disparity along per-pixel epipolar lines of non-rectified
    (H, W) uint8 images: at search step o the target x is x + o and its y
    follows the query pixel's epipolar line y = -(a x + c) / b, (a, b, c) =
    F [x, y, 1].  Each window pixel samples the target at its own line's y
    (the JAX package's per-pixel deviation from the reference).

    Returns (target_x (H, W) int32, target_y (H, W) int32, valid (H, W))."""
    h, w = query.shape
    dev = query.device
    q = query.to(torch.int32)
    t = target.to(torch.int32)
    half = window // 2
    F = fundamental.to(device=dev, dtype=torch.float32)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.int32),
                            torch.arange(w, device=dev, dtype=torch.int32), indexing="ij")
    xf, yf = xs.to(torch.float32), ys.to(torch.float32)
    a = F[0, 0] * xf + F[0, 1] * yf + F[0, 2]
    b = F[1, 0] * xf + F[1, 1] * yf + F[1, 2]
    c = F[2, 0] * xf + F[2, 1] * yf + F[2, 2]
    b = torch.where(b == 0, torch.tensor(1e-20, device=dev), b)
    offsets = _offsets(max_disparity, direction)
    costs, sys_ = [], []
    for o in offsets:
        sx = xs + o
        sy = _floor_to_i32(-(a * sx.to(torch.float32) + c) / b)
        in_img = (sx - half >= 0) & (sx + half < w) & (sy - half >= 0) & (sy + half < h)
        warped = t[torch.clamp(sy, 0, h - 1).long(), torch.clamp(sx, 0, w - 1).long()]
        cost = _box_sum(torch.abs(q - warped), window)
        costs.append(torch.where(in_img, cost, torch.inf))
        sys_.append(sy)
    costs = torch.stack(costs)
    best_cost, best = torch.min(costs, dim=0)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    tx = xs + offs[best]
    ty = torch.gather(torch.stack(sys_), 0, best[None])[0]
    return tx, ty, torch.isfinite(best_cost) & _interior(h, w, half, dev)


def _is_parallel_f(F) -> bool:
    """The reference's "parallel images" F pattern: all zeros except
    F[1][2] == -1 and F[2][1] == 1."""
    F = np.asarray(F, np.float32)
    pattern_ok = F[1, 2] == -1.0 and F[2, 1] == 1.0
    rest = F.copy()
    rest[1, 2] = 0.0
    rest[2, 1] = 0.0
    return bool(pattern_ok and not np.any(rest != 0.0))


def generate_disparity_matches(query, target, fundamental, max_disparity: int = 64,
                               window: int = 11, direction: str = "right", device=None):
    """Dense stereo matches of two (H, W) uint8 images on ``device`` (when
    None: the device of a tensor ``query``, else ``cuda:0``, which raises
    without a card): the scanline search when F has the parallel-image
    pattern, else the epipolar one.  Returns (loc0 (N, 2), loc1 (N, 2))
    float32, the valid query pixels in row-major order and their targets."""
    if window == 0 or window % 2 == 0 or window > 31:
        raise ValueError("window size must be odd, >0 and <=31")
    q = as_device_tensor(query, device)
    if max_disparity > q.shape[1]:
        raise ValueError("max disparity cannot exceed image width")
    t = as_device_tensor(target, q.device)
    F = as_device_tensor(fundamental, "cpu").to(torch.float32)
    h, w = q.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=q.device), torch.arange(w, device=q.device),
                            indexing="ij")
    if _is_parallel_f(F):
        disp, valid = disparity_scan_matching(q, t, max_disparity, window, direction)
        tx, ty = xs + disp, ys
    else:
        tx, ty, valid = disparity_matching(q, t, F, max_disparity, window, direction)
    loc0 = torch.stack([xs[valid], ys[valid]], dim=1).to(torch.float32)
    loc1 = torch.stack([tx[valid], ty[valid]], dim=1).to(torch.float32)
    return loc0, loc1


def compute_stereo_scale(loc0: torch.Tensor, loc1: torch.Tensor, scale: float = 8.0):
    """(x0, y0, scale * |loc0 - loc1|): the depth proxy of the reference's
    camera-free variant."""
    d = torch.linalg.norm(loc0 - loc1, dim=-1)
    return torch.cat([loc0, (scale * d)[..., None]], dim=-1)


def compute_stereo_focal(loc0: torch.Tensor, loc1: torch.Tensor, foc: float, baseline: float,
                         doffset: float = 0.0):
    """(x1, y1, foc * baseline / (x0 - x1 + doffset))."""
    z = foc * baseline / (loc0[..., 0] - loc1[..., 0] + doffset)
    return torch.stack([loc1[..., 0], loc1[..., 1], z], dim=-1)


def heat_map(values) -> np.ndarray:
    """Red -> green -> blue heat map of values in [0, 1], (..., 3) uint8."""
    v = np.asarray(values, np.float32)
    lowhalf = v <= 0.5
    v2 = np.where(lowhalf, v * 2.0, v * 2.0 - 1.0)
    r = np.where(lowhalf, 255 * (1 - v2) + 0.5, 0)
    g = np.where(lowhalf, 255 * v2 + 0.5, 255 * (1 - v2) + 0.5)
    b = np.where(lowhalf, 0, 255 * v2 + 0.5)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def write_disparity_image(points, path: str, interpolation_radius: int = 0) -> str:
    """Depth points (N, 3) (x, y, z) as a min-max-normalised heat-map PNG,
    optionally box-smoothed over (2 r + 1)^2 pixels; returns the path
    written (".png" appended when missing)."""
    from ssrlcv_tpu_torch.io.images import write_image

    pts = points.detach().cpu().numpy() if isinstance(points, torch.Tensor) else np.asarray(points)
    xs = pts[:, 0].astype(np.int64)
    ys = pts[:, 1].astype(np.int64)
    z = pts[:, 2]
    depth = np.zeros((int(ys.max()) + 1, int(xs.max()) + 1), np.float32)
    depth[ys, xs] = z
    zmin, zmax = float(z.min()), float(z.max())
    norm = (depth - zmin) / max(zmax - zmin, 1e-12)
    if interpolation_radius > 0:
        from scipy.ndimage import uniform_filter

        norm = uniform_filter(norm, size=2 * interpolation_radius + 1)
    if not path.endswith(".png"):
        path += ".png"
    write_image(path, heat_map(norm))
    return path
