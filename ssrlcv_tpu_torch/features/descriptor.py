"""SIFT descriptor generation.

Counterpart of ``ssrlcv_tpu/features/descriptor.py``: raw 4x4x8 histograms
over each keypoint's rotated sample lattice (kernel K2,
``desc_kernel.descriptor_histograms``), then the reference epilogue:
two-pass L2 normalisation with a 0.2 clamp, x255, round, uint8.  The
reference quirks (window-width Gaussian, sign-preserving fmod angle,
unwrapped angular distance) live in the kernel and its plain version.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu.config import SIFTParams
from ssrlcv_tpu_torch.features.desc_kernel import descriptor_histograms
from ssrlcv_tpu_torch.features.detector import SSKeyPoints


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
                     w_max: int):
    """Returns (descriptors (K, 128) uint8, loc_image (K, 2) float32) for
    oriented keypoints on one gradient plane; loc_image = octave loc *
    pixel_width (absolute image coordinates).  ``w_max`` bounds the window
    half-width of every keypoint given (``sift._bucket_windows``)."""
    v = descriptor_histograms(
        gx, gy, kps.loc.contiguous(), kps.theta.contiguous(), kps.sigma.contiguous(),
        float(pixel_width), float(params.descriptor_contrib_width), w_max)
    return descriptor_epilogue(v, kps.mask), kps.loc * pixel_width
