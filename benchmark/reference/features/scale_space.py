"""Gaussian scale space and difference-of-Gaussians pyramid.

Counterpart of ``ssrlcv_tpu/features/scale_space.py``, in the same order:
uint8 -> float (0..255), makeBinnable pad, one 2x upsample per negative
starting octave, per octave an incremental blur chain (each blur convolves
the previous blur's output), the next octave seeded from the 2x-binned blur
``numBlurs-3``, min-max normalised blurs, DoG = blur[b+1] - blur[b], and a
min-max normalised copy of each DoG slice for refinement and description.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.config import SIFTParams
from benchmark.reference.ops import image_ops as ops


class Octave(NamedTuple):
    """One octave of the DoG scale space."""

    dog_raw: torch.Tensor   # (B-1, H, W) raw DoG values (extrema detection)
    dog_norm: torch.Tensor  # (B-1, H, W) min-max normalised DoG
    sigmas: tuple           # per-DoG-slice sigma
    pixel_width: float


def octave_sigmas(params: SIFTParams, octave_index: int) -> list[float]:
    """Absolute blur sigmas of one octave: initial * blur_mult^b, scaled by
    octave_mult^octave."""
    s0 = params.initial_sigma * (params.octave_sigma_multiplier ** octave_index)
    return [s0 * (params.blur_sigma_multiplier ** b) for b in range(params.blurs_per_octave)]


def build_scale_space(pixels_u8: torch.Tensor, params: SIFTParams,
                      height: int, width: int) -> tuple[Octave, ...]:
    """uint8 (H, W) image -> one Octave per octave; octave i has pixel width
    2^(starting_octave + i) relative to the input image."""
    img = ops.to_float(pixels_u8)

    planned = params.starting_octave + params.num_octaves
    h, w = height, width
    nh, nw, border = ops.make_binnable_shape(h, w, max(planned, 0))
    if (nh, nw) != (h, w):
        img = ops.add_buffer_border(img, border)
        img = ops.bin2x(img)
        h, w = nh // 2, nw // 2

    pixel_width = 1.0
    for _ in range(-params.starting_octave):
        img = ops.upsample2x(img)
        h, w = h * 2, w * 2
        pixel_width /= 2.0
    for _ in range(max(params.starting_octave, 0)):
        img = ops.bin2x(img)
        h, w = h // 2, w // 2
        pixel_width *= 2.0

    octaves = []
    cur = img
    keep = params.blurs_per_octave - 2
    for o in range(params.num_octaves):
        sigmas = octave_sigmas(params, o)
        blurs = []
        for s in sigmas:
            cur = ops.convolve_separable_symmetric(
                cur, ops.gaussian_kernel_1d(s, pixel_width, params.kernel_size[0]))
            blurs.append(cur)
        if o + 1 < params.num_octaves:
            cur = ops.bin2x(blurs[keep - 1])
        normed = [ops.normalize_minmax(b) for b in blurs]
        dog = torch.stack([normed[b + 1] - normed[b] for b in range(len(blurs) - 1)])
        lo = torch.amin(dog, dim=(1, 2), keepdim=True)
        hi = torch.amax(dog, dim=(1, 2), keepdim=True)
        dog_norm = (dog - lo) / (hi - lo)
        octaves.append(Octave(dog_raw=dog, dog_norm=dog_norm,
                              sigmas=tuple(sigmas[:-1]), pixel_width=pixel_width))
        pixel_width *= 2.0
    return tuple(octaves)
