"""SIFT descriptor generation.

Counterpart of ``ssrlcv_tpu/features/descriptor.py``: raw 4x4x8 histograms
over each keypoint's rotated sample lattice (kernel K2,
``desc_kernel.descriptor_histograms``; with ``use_patches``, K2's plain math
over per-keypoint patches from kernel K5), then the reference epilogue:
two-pass L2 normalisation with a 0.2 clamp, x255, round, uint8.  The
reference quirks (window-width Gaussian, sign-preserving fmod angle,
unwrapped angular distance) live in the kernel and its plain version.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu_torch.features.desc_kernel import (descriptor_histograms,
                                                   descriptor_histograms_plain)
from ssrlcv_tpu_torch.features.detector import SSKeyPoints
from ssrlcv_tpu_torch.features.patches import patch_sampler

CHUNK = 512  # keypoints per patch extraction: chunk x SPA x 256 x 4 B x 2 of patches


def descriptor_epilogue(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Two-pass L2 normalise + 0.2 clamp + uint8 quantise of raw (K, 128)
    histograms; dead slots zeroed."""
    n1 = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    v = torch.clamp(v / torch.clamp(n1, min=1e-20), max=0.2)
    n2 = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    v = torch.round(255.0 * v / torch.clamp(n2, min=1e-20))
    desc = torch.clamp(v, 0, 255).to(torch.uint8)
    return torch.where(mask[:, None], desc, 0)


def fill_descriptors(gx, gy, kps: SSKeyPoints, pixel_width: float, params: SIFTParams,
                     w_max: int, use_patches: bool = False, w_patch: int | None = None):
    """Returns (descriptors (K, 128) uint8, loc_image (K, 2) float32) for
    oriented keypoints on one gradient plane; loc_image = octave loc *
    pixel_width (absolute image coordinates).  ``w_max`` bounds the window
    half-width of every keypoint given (``sift._bucket_windows``).

    use_patches: sample through per-keypoint patches (K5,
    ``patches.extract_patches``) and the plain histogram math, ``CHUNK``
    keypoints at a time, instead of kernel K2; the samples of in-window
    keypoints are the same.  ``w_patch`` (default ``w_max``) sizes the
    patches."""
    loc, theta, sigma = kps.loc.contiguous(), kps.theta.contiguous(), kps.sigma.contiguous()
    lam = float(params.descriptor_contrib_width)
    if use_patches:
        parts = [descriptor_histograms_plain(
            gx, gy, loc[s:s + CHUNK], theta[s:s + CHUNK], sigma[s:s + CHUNK],
            float(pixel_width), lam, w_max, chunk=CHUNK,
            sample=patch_sampler(gx, gy, loc[s:s + CHUNK], w_patch or w_max))
            for s in range(0, loc.shape[0], CHUNK)]
        v = torch.cat(parts) if parts else torch.zeros((0, 128), device=gx.device)
    else:
        v = descriptor_histograms(gx, gy, loc, theta, sigma, float(pixel_width), lam, w_max)
    return descriptor_epilogue(v, kps.mask), kps.loc * pixel_width
