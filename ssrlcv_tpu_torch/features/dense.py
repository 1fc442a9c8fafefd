"""Dense SIFT and dense Window_NxN patch descriptors.

Counterpart of ``ssrlcv_tpu/features/dense.py``:

  * dense SIFT: a descriptor at every interior pixel (``params.border`` px)
    of the min-max-normalised image, at unit sigma and pixel width, so the
    orientation window is ceil(3 * 1.5) = 5 and the descriptor window
    ceil(6) = 6.  The fast path computes every orientation at once as a
    36-bin stencil field, compacts the oriented pixels and describes them
    all in one launch of kernel K2 (``desc_kernel.descriptor_histograms``);
    the gather path (``fast=False``) runs the sparse machinery, kernel K1
    (``orient_kernel.orientation_histograms``) then K2, over every interior
    pixel, and is the oracle of the fast one.
  * Window_NxN: the raw NxN pixel patch at every interior pixel, matched
    under the sum of absolute differences (``sad_best_target``, or the
    matchers of ``matching/match.py`` with ``metric="sad"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ssrlcv_tpu_torch.config import SIFTParams
from ssrlcv_tpu_torch.core.device import as_device_tensor
from ssrlcv_tpu_torch.core.types import FeatureSet
from ssrlcv_tpu_torch.features.descriptor import fill_descriptors
from ssrlcv_tpu_torch.features.detector import SSKeyPoints
from ssrlcv_tpu_torch.features.orientation import compute_orientations
from ssrlcv_tpu_torch.matching.distance import sad_matrix
from ssrlcv_tpu_torch.ops import image_ops as ops

WINDOW_SIZES = (3, 9, 15, 25, 31)  # the reference's Window_NxN instantiations


def _as_pixels(pixels, device) -> torch.Tensor:
    """(H, W) uint8 pixels (RGB mixed down) on ``device`` (as
    ``as_device_tensor``)."""
    return ops.to_bw(as_device_tensor(pixels, device))


def _interior_grid(h: int, w: int, border: int, device=None) -> torch.Tensor:
    """(x, y) float32 of every pixel at least ``border`` from each edge,
    row-major."""
    ys, xs = torch.meshgrid(torch.arange(border, h - border, device=device),
                            torch.arange(border, w - border, device=device), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1).to(torch.float32)


def _dense_orientation_field(gx, gy, params: SIFTParams, w_or: int):
    """Orientations of every interior pixel as stencil compute: at unit
    sigma the window and Gaussian are the same at every pixel, so the 36-bin
    weighted histogram field is 36 separable (2 w_or + 1)-tap convolutions of
    |g| * [bin == b], followed by the peak finding and parabola interpolation
    of ``orientation.peaks_from_histograms`` over the whole field.

    Returns (theta, ok), flat over (interior pixels x max_orientations) in
    the emission order of ``compute_orientations``: pixel-major, then the
    orientations in descending histogram magnitude (equal magnitudes keep
    the lower bin first)."""
    lam = params.orientation_contrib_width
    b = params.border
    h, w = gx.shape
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.atan2(gy, gx) + 2.0 * math.pi, 2.0 * math.pi)
    # a quotient as in the JAX package (a divisor held as a tensor: CUDA
    # turns division by a Python number into a product by its reciprocal)
    rad10 = torch.tensor(math.pi / 18.0, dtype=torch.float32, device=gx.device)
    bins = torch.clamp(torch.floor(ang / rad10).to(torch.int32), 0, 35)

    denom = 2.0 * lam * lam  # sigma = 1, pixel_width = 1
    offs = np.arange(-w_or, w_or + 1, dtype=np.float64)
    taps = np.exp(-(offs * offs) / denom).astype(np.float32)
    ids = torch.arange(36, dtype=torch.int32, device=gx.device)[:, None, None]
    planes = torch.where(bins[None] == ids, mag[None], 0.0)
    # the border mode is unobservable for interior pixels (border > w_or),
    # which are all the field is cut to
    hist = ops.convolve_separable_symmetric(planes, taps)[:, b:h - b, b:w - b]
    del planes

    prev = torch.roll(hist, 1, dims=0)
    nxt = torch.roll(hist, -1, dims=0)
    maxh = torch.amax(hist, dim=0, keepdim=True) * params.orientation_threshold
    is_peak = (hist >= maxh) & (hist >= prev) & (hist >= nxt)
    dd = prev - 2.0 * hist + nxt
    off = torch.where(torch.abs(dd) > 0, (prev - nxt) / dd, 0.0)
    bc = torch.from_numpy((np.arange(36, dtype=np.float64) * np.pi / 18.0).astype(np.float32))
    theta = torch.remainder(off * np.float32(np.pi / 36.0) + bc.to(gx.device)[:, None, None]
                            + np.float32(2.0 * np.pi), np.float32(2.0 * np.pi))
    mags = torch.where(is_peak, hist, -torch.inf)
    del prev, nxt, is_peak, dd, off, hist

    # top-m in descending magnitude by iterative argmax over the bin axis
    # (torch.argmax returns the first maximum: ties go to the lowest bin)
    thetas, oks = [], []
    for _ in range(params.max_orientations):
        top, sel = torch.max(mags, dim=0, keepdim=True)
        thetas.append(torch.gather(theta, 0, sel)[0])
        oks.append(top[0] > 0.0)  # drops zero-magnitude slots and -inf (no peak)
        mags.scatter_(0, sel, -torch.inf)
    theta_f = torch.stack(thetas, dim=-1).reshape(-1)
    ok_f = torch.stack(oks, dim=-1).reshape(-1)
    return theta_f, ok_f


def _dense_compact(theta_f, ok_f, params: SIFTParams, w: int):
    """The oriented slots of the field in order (a stable compaction):
    (loc (n, 2), theta (n,)) of the n slots with ``ok_f``."""
    keep = torch.nonzero(ok_f).squeeze(1)
    pix = torch.div(keep, params.max_orientations, rounding_mode="floor")
    wi = w - 2 * params.border
    loc = torch.stack([pix % wi, torch.div(pix, wi, rounding_mode="floor")], dim=1)
    return (loc + params.border).to(torch.float32), theta_f[keep]


def _unit_keypoints(loc, theta) -> SSKeyPoints:
    """Live keypoints at ``loc`` with angles ``theta``, sigma 1."""
    n = loc.shape[0]
    dev = loc.device
    return SSKeyPoints(blur=torch.zeros(n, dtype=torch.int64, device=dev), loc=loc,
                       intensity=torch.zeros(n, device=dev), sigma=torch.ones(n, device=dev),
                       theta=theta, mask=torch.ones(n, dtype=torch.bool, device=dev))


def _dense_describe(gx, gy, loc, theta, image_id: int, params: SIFTParams,
                    w_de: int) -> FeatureSet:
    """Descriptors of the n oriented dense keypoints (one K2 launch on the
    card) into a FeatureSet of capacity n rounded up to 128 (at least 128);
    rows past n are masked, as ``FeatureSet.empty`` leaves them."""
    n = loc.shape[0]
    dev = gx.device
    desc, loc_image = fill_descriptors(gx, gy, _unit_keypoints(loc, theta), 1.0, params,
                                       w_max=w_de)
    out = FeatureSet.empty(max(((n + 127) // 128) * 128, 128), parent=image_id, device=dev)
    out.loc[:n] = loc_image
    out.sigma[:n] = 1.0
    out.theta[:n] = theta
    out.descriptors[:n] = desc
    out.mask[:n] = True
    return out


def generate_dense_sift(pixels, params: Optional[SIFTParams] = None, image_id: int = -1,
                        fast: Optional[bool] = None, device=None) -> FeatureSet:
    """Dense SIFT of one grayscale (or RGB) uint8 image: up to
    ``max_orientations`` descriptors per interior pixel, in pixel-major
    order, on ``device`` (when None: the device of a tensor ``pixels``,
    else ``cuda:0``, which raises without a card).

    fast=True (the default): the stencil orientation field, its compaction
    and one K2 launch.  fast=False: the gather path, K1 over every interior
    pixel then K2 over the oriented ones, the oracle of the fast path."""
    params = params or SIFTParams()
    px = _as_pixels(pixels, device)
    h, w = int(px.shape[0]), int(px.shape[1])
    fast = True if fast is None else fast
    img = ops.normalize_minmax(ops.to_float(px))
    w_or = int(math.ceil(3.0 * params.orientation_contrib_width))  # 5
    w_de = int(math.ceil(params.descriptor_contrib_width))          # 6
    gx, gy = ops.pixel_gradients(img)

    if fast:
        # the field is cut to the interior, where the border mode of its
        # convolutions is unobservable only if the window stays inside
        if params.border <= w_or:
            raise ValueError(f"dense SIFT needs params.border ({params.border}) > the "
                             f"orientation window ({w_or})")
        theta_f, ok_f = _dense_orientation_field(gx, gy, params, w_or)
        loc, theta = _dense_compact(theta_f, ok_f, params, w)
        return _dense_describe(gx, gy, loc, theta, image_id, params, w_de)

    loc = _interior_grid(h, w, params.border, device=px.device)
    kps = _unit_keypoints(loc, torch.zeros_like(loc[:, 0]))
    oriented = compute_orientations(gx, gy, kps, 1.0, params, w_max=w_or)
    oriented = oriented.select(torch.nonzero(oriented.mask).squeeze(1))
    return _dense_describe(gx, gy, oriented.loc, oriented.theta, image_id, params, w_de)


@dataclasses.dataclass
class WindowFeatures:
    """Dense NxN patch descriptors; they go through the matchers as a
    FeatureSet does (``loc``, ``descriptors``, ``mask``, ``capacity``).

    descriptors: (K, N*N) uint8 raw patches; loc: (K, 2) float32."""

    loc: torch.Tensor
    descriptors: torch.Tensor
    mask: torch.Tensor
    window: int = 9

    @property
    def capacity(self) -> int:
        return self.loc.shape[0]


def _extract_patches(pixels: torch.Tensor, window: int) -> torch.Tensor:
    """All NxN patches of the image as (H-N+1)*(W-N+1) rows, row-major over
    their top-left corners, each patch row-major."""
    patches = pixels.unfold(0, window, 1).unfold(1, window, 1)  # (H-N+1, W-N+1, N, N)
    return patches.reshape(-1, window * window)


def generate_window_features(pixels, window: int = 9, image_id: int = -1,
                             device=None) -> WindowFeatures:
    """The raw NxN patch at every pixel at least N//2 from each edge, on
    ``device`` (as ``generate_dense_sift``)."""
    if window not in WINDOW_SIZES:
        raise ValueError(f"window must be one of {WINDOW_SIZES}, got {window}")
    px = _as_pixels(pixels, device)
    h, w = int(px.shape[0]), int(px.shape[1])
    desc = _extract_patches(px, window)
    loc = _interior_grid(h, w, window // 2, device=px.device)  # the patches' row order
    return WindowFeatures(loc=loc, descriptors=desc,
                          mask=torch.ones(desc.shape[0], dtype=torch.bool, device=px.device),
                          window=window)


def sad_best_target(q_desc: torch.Tensor, t_desc: torch.Tensor, t_valid: torch.Tensor,
                    chunk: int = 256):
    """Best target per query under the sum of absolute differences (the
    Window_NxN distance), ``chunk`` queries at a time: (idx (Nq,) int32,
    dist (Nq,) float32); the first minimum on ties, +inf over invalid
    targets only."""
    idx_out, dist_out = [], []
    for s in range(0, q_desc.shape[0], chunk):
        d = sad_matrix(q_desc[s:s + chunk], t_desc).to(torch.float32)
        d = torch.where(t_valid[None, :], d, torch.inf)
        best, idx = torch.min(d, dim=1)
        idx_out.append(idx.to(torch.int32))
        dist_out.append(best)
    if not idx_out:
        return (torch.zeros((0,), dtype=torch.int32, device=q_desc.device),
                torch.zeros((0,), dtype=torch.float32, device=q_desc.device))
    return torch.cat(idx_out), torch.cat(dist_out)
