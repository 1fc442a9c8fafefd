"""SIFT detection of one octave on the card: two CUDA kernels (wrapper).

Replaces no TPU kernel: the JAX package's detector
(``ssrlcv_tpu/features/detector.py``) is XLA operations.  The CUDA kernels
are ``csrc/detect.cu``; their plain PyTorch twin is
``detector.find_keypoints_octave_plain`` followed by
``detector.check_descriptor_border``, about 800 launches an octave.

``detect_keypoints`` launches the extrema kernel (``extrema_flags``),
compacts its flags with ``torch.nonzero`` (the octave's one host wait) and
launches the keypoint kernel (``keypoint_slots``);
``detector.find_keypoints_octave`` calls it for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ssrlcv_tpu_torch import _cuda
from ssrlcv_tpu_torch.config import SIFTParams

MAX_SLICES = 64  # csrc/detect.cu kMaxSlices


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python number meets a float32 tensor."""
    return float(np.float32(v))


def detect_keypoints(dog_raw: torch.Tensor, dog_norm: torch.Tensor, sigmas: tuple,
                     params: SIFTParams, capacity: int, pixel_width=None):
    """The six ``SSKeyPoints`` fields of one octave's ``capacity`` slots,
    equal to the bit to ``find_keypoints_octave_plain`` (then, with
    ``pixel_width``, ``check_descriptor_border``) on the same CUDA tensors,
    and the number of extrema found (the slots keep the first
    ``capacity``)."""
    if dog_raw.dim() != 3 or dog_norm.shape != dog_raw.shape or dog_norm.device != dog_raw.device:
        raise ValueError(f"dog_raw and dog_norm must be one (D, H, W) shape on one device, got "
                         f"{tuple(dog_raw.shape)} on {dog_raw.device} and "
                         f"{tuple(dog_norm.shape)} on {dog_norm.device}")
    if dog_raw.dtype != torch.float32 or dog_norm.dtype != torch.float32:
        raise TypeError(f"dog_raw and dog_norm must be float32, got {dog_raw.dtype}, "
                        f"{dog_norm.dtype}")
    d, h, w = dog_raw.shape
    if d > MAX_SLICES or len(sigmas) < d - 1:
        raise ValueError(f"need at most {MAX_SLICES} DoG slices and a sigma for each but the "
                         f"last, got {d} slices and {len(sigmas)} sigmas")
    if dog_raw.device.type != "cuda":
        raise ValueError(f"detect_keypoints: needs CUDA tensors, got {dog_raw.device}")
    raw, norm = dog_raw.contiguous(), dog_norm.contiguous()
    thr = params.noise_threshold * 0.8
    found = torch.nonzero(extrema_flags(raw, thr if thr > 0.0 else 0.0)).squeeze(1)
    fields = keypoint_slots(raw, norm, found[:capacity].contiguous(), sigmas, params, capacity,
                            pixel_width)
    return fields, found.shape[0]


def extrema_flags(dog_raw: torch.Tensor, threshold: float) -> torch.Tensor:
    """The extrema kernel on a contiguous float32 (D, H, W) CUDA ``dog_raw``:
    one bool a voxel of the interior (D-2, H-2, W-2), flat, true at a 3x3x3
    extremum (ties count) of magnitude at least ``threshold``.  One launch."""
    d, h, w = dog_raw.shape
    flags = torch.empty((max(d - 2, 0) * max(h - 2, 0) * max(w - 2, 0),), dtype=torch.bool,
                        device=dog_raw.device)
    if flags.numel():
        _cuda.check(_cuda.library().ssrlcv_detect_extrema(
            dog_raw.data_ptr(), flags.data_ptr(), d, h, w, _f32(threshold),
            _cuda.stream_ptr(dog_raw.device)), "ssrlcv_detect_extrema")
        detect_keypoints.launches += 1
    return flags


def keypoint_slots(dog_raw: torch.Tensor, dog_norm: torch.Tensor, found: torch.Tensor,
                   sigmas: tuple, params: SIFTParams, capacity: int, pixel_width=None):
    """The keypoint kernel on contiguous float32 (D, H, W) CUDA planes:
    the six ``SSKeyPoints`` fields of ``capacity`` slots, slot i holding
    extremum ``found[i]`` (flat interior indices, int64, at most
    ``capacity``) refined and tested, the rest empty.  One launch."""
    d, h, w = dog_raw.shape
    dev = dog_raw.device
    blur = torch.empty((capacity,), dtype=torch.int64, device=dev)
    loc = torch.empty((capacity, 2), dtype=torch.float32, device=dev)
    intensity, sigma, theta = (torch.empty((capacity,), dtype=torch.float32, device=dev)
                               for _ in range(3))
    mask = torch.empty((capacity,), dtype=torch.bool, device=dev)
    if capacity:
        sig = np.zeros(d, np.float32)
        sig[:min(len(sigmas), d)] = np.asarray(sigmas[:d], dtype=np.float32)
        # refine_keypoints' sigma_min and blur_multiplier, as the plain chain forms them
        s0 = float(sigmas[0])
        mult = float(sigmas[1]) / s0 if params.subpixel else 1.0
        pw = 1.0 if pixel_width is None else pixel_width
        _cuda.check(_cuda.library().ssrlcv_detect_keypoints(
            dog_raw.data_ptr(), dog_norm.data_ptr(), found.data_ptr(), found.shape[0], capacity,
            d, h, w, sig.ctypes.data, _f32(params.noise_threshold), _f32(params.edge_threshold),
            _f32(s0), _f32(mult), _f32(params.descriptor_contrib_width),
            float(np.float32(1.0) / np.float32(pw)), int(params.subpixel),
            params.max_refine_attempts, int(pixel_width is not None),
            blur.data_ptr(), loc.data_ptr(), intensity.data_ptr(), sigma.data_ptr(),
            theta.data_ptr(), mask.data_ptr(), _cuda.stream_ptr(dev)), "ssrlcv_detect_keypoints")
        detect_keypoints.launches += 1
    return blur, loc, intensity, sigma, theta, mask


detect_keypoints.launches = 0
