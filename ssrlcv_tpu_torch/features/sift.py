"""SIFT feature generation: the full front end.

Counterpart of ``ssrlcv_tpu/features/sift.py`` in its count-exact kernel
form: DoG scale space -> per-octave detection (first ``octave_capacity``
extrema) -> descriptor-border check -> per (octave, blur bucket 1..B-3):
compact the bucket's keypoints, orientations (K1) with the bucket's window,
compact the oriented copies, descriptors (K2) -> aggregation in octave ->
blur -> detection order, truncated at ``max_keypoints``, into one
fixed-capacity FeatureSet.

Live counts come from ``torch.nonzero``, so no bucket saturates and no
keypoint is dropped short of ``max_keypoints`` (the behaviour of the JAX
package's kernel path; its CPU gather path would saturate at static bucket
capacities instead).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu_torch.core.types import FeatureSet
from ssrlcv_tpu_torch.features import scale_space as ss
from ssrlcv_tpu_torch.features.descriptor import fill_descriptors
from ssrlcv_tpu_torch.features.detector import check_descriptor_border, find_keypoints_octave
from ssrlcv_tpu_torch.features.orientation import compute_orientations
from ssrlcv_tpu_torch.ops import image_ops as ops


def octave_capacity(params: SIFTParams, octave_index: int, height: int, width: int) -> int:
    """Detection capacity per octave: 1/64 of the octave's pixel count, at
    least 1024, rounded up to a multiple of 128."""
    scale = 2.0 ** (params.starting_octave + octave_index)
    npix = int(height * width / (scale * scale))
    cap = max(1024, npix // 64)
    return ((cap + 127) // 128) * 128


def _bucket_windows(params: SIFTParams, blur: int) -> tuple[int, int]:
    """Orientation/descriptor window bounds for keypoints of one DoG blur
    bucket: sigma/pixel_width <= (initial/0.5) * mult^(blur + 0.5) in every
    octave (refinement moves sigma by at most half a blur)."""
    ratio = (params.initial_sigma / 0.5) * params.blur_sigma_multiplier ** (blur + 0.5)
    w_o = int(math.ceil(3.0 * params.orientation_contrib_width * ratio))
    w_d = int(math.ceil(params.descriptor_contrib_width * ratio))
    return w_o, w_d


def _describe_buckets(params: SIFTParams):
    """DoG blur slices that can carry extrema: 1 .. B-3."""
    return range(1, params.blurs_per_octave - 2)


def _describe_bucket(kps, gx, gy, params: SIFTParams, b: int, pixel_width: float):
    """One blur bucket on its gradient plane: compact -> orientations (K1)
    -> compact -> descriptors (K2).  Returns (loc_image, sigma, theta,
    desc) of the bucket's oriented keypoints in emission order."""
    w_o, w_d = _bucket_windows(params, b)
    sel = torch.nonzero(kps.mask & (kps.blur == b)).squeeze(1)
    oriented = compute_orientations(gx, gy, kps.select(sel), pixel_width, params, w_max=w_o)
    oriented = oriented.select(torch.nonzero(oriented.mask).squeeze(1))
    desc, loc_image = fill_descriptors(gx, gy, oriented, pixel_width, params, w_max=w_d)
    return loc_image, oriented.sigma, oriented.theta, desc


def generate_features(pixels, params: Optional[SIFTParams] = None, image_id: int = -1,
                      device=None) -> FeatureSet:
    """SIFT features of one grayscale (or RGB) uint8 image, on ``device``
    (the device of ``pixels`` when it is a tensor and ``device`` is None,
    else the CPU).  Returns a FeatureSet of capacity ``max_keypoints``
    ordered (octave, blur bucket, detection order)."""
    params = params or SIFTParams()
    if device is None:
        device = pixels.device if isinstance(pixels, torch.Tensor) else torch.device("cpu")
    px = torch.as_tensor(np.asarray(pixels) if not isinstance(pixels, torch.Tensor) else pixels,
                         device=device)
    if px.ndim == 3:
        px = ops.to_bw(px)
    h, w = int(px.shape[0]), int(px.shape[1])

    parts = []
    for o, octave in enumerate(ss.build_scale_space(px, params, h, w)):
        sigmas = tuple(ss.octave_sigmas(params, o))[: params.blurs_per_octave - 1]
        pixel_width = float(2.0 ** (params.starting_octave + o))
        cap = octave_capacity(params, o, h, w)
        kps = find_keypoints_octave(octave.dog_raw, octave.dog_norm, sigmas, params, cap)
        oh, ow = octave.dog_raw.shape[1], octave.dog_raw.shape[2]
        kps = check_descriptor_border(kps, (oh, ow), params.descriptor_contrib_width,
                                      pixel_width)
        gx, gy = ops.pixel_gradients(octave.dog_norm)
        for b in _describe_buckets(params):
            parts.append(_describe_bucket(kps, gx[b], gy[b], params, b, pixel_width))

    loc = torch.cat([p[0] for p in parts])
    sigma = torch.cat([p[1] for p in parts])
    theta = torch.cat([p[2] for p in parts])
    desc = torch.cat([p[3] for p in parts])
    cap = params.max_keypoints
    n = loc.shape[0]
    if n > cap:
        from ssrlcv_tpu.logging import logger

        logger.warn(f"image {image_id}: {n} valid features exceed max_keypoints={cap} — "
                    "tail dropped by global aggregation; raise SIFTParams.max_keypoints")
        n = cap
    out = FeatureSet.empty(cap, parent=image_id, device=device)
    out.loc[:n] = loc[:n]
    out.sigma[:n] = sigma[:n]
    out.theta[:n] = theta[:n]
    out.descriptors[:n] = desc[:n]
    out.mask[:n] = True
    return out


def generate_features_many(pixel_list, params: Optional[SIFTParams] = None,
                           image_ids: Optional[list] = None, device=None) -> list:
    """SIFT features of several images, one after another on ``device``."""
    ids = list(image_ids) if image_ids is not None else list(range(len(pixel_list)))
    if len(ids) != len(pixel_list):
        raise ValueError(f"generate_features_many: {len(pixel_list)} images but "
                         f"{len(ids)} image_ids")
    return [generate_features(p, params, image_id=i, device=device)
            for p, i in zip(pixel_list, ids)]
