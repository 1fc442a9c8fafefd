"""The direct plane sampler of the orientation and descriptor histograms
(the part of ``ssrlcv_tpu_torch/features/patches.py`` the plain versions
use)."""

from __future__ import annotations


def plane_sampler(gx, gy):
    """The direct sampler: ``sample(sl, yi, xi)`` indexes the planes at
    (yi, xi), already clipped to the plane, for keypoints ``sl``."""

    def sample(sl, yi, xi):
        return gx[yi, xi], gy[yi, xi]

    return sample
