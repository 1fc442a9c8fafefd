"""K3: epipolar-gated best target per query (wrapper, plain version).

Replaces the Pallas kernel ``ssrlcv_tpu/matching/pallas_match.py``
(``_match_kernel_i8``, public ``pallas_best_target``).  The CUDA kernel is
``csrc/match.cu``; its plain PyTorch twin is ``best_target_plain``:
``distance.best_target_chunked`` with the double-constrained gate of
``match._epipolar_segment_mask``.  Both the seed pass (unconstrained) and
the constrained match go through ``best_target``.

``best_target`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu_torch import _cuda
from ssrlcv_tpu_torch.matching.distance import best_target_chunked


def epipolar_segment_mask(p1, p2, t_loc, epsilon: float) -> torch.Tensor:
    """The double-constrained acceptance test: x-range gate around the
    segment plus the vertical-segment test or the vertical distance to the
    segment's line.  p1, p2: (C, 2); t_loc: (Nt, 2) -> (C, Nt) bool."""
    swap = p1[:, 0] >= p2[:, 0]
    left = torch.where(swap[:, None], p2, p1)
    right = torch.where(swap[:, None], p1, p2)
    tx = t_loc[None, :, 0]
    ty = t_loc[None, :, 1]

    in_x = (tx >= (left[:, 0] - epsilon)[:, None]) & (tx <= (right[:, 0] + epsilon)[:, None])

    vertical = (left[:, 0] == right[:, 0])[:, None]
    top = torch.minimum(p1[:, 1], p2[:, 1])[:, None]
    bottom = torch.maximum(p1[:, 1], p2[:, 1])[:, None]
    vert_ok = (top - epsilon <= ty) & (bottom + epsilon >= ty)

    dx = left[:, 0] - right[:, 0]
    slope = (left[:, 1] - right[:, 1]) / torch.where(dx == 0, 1.0, dx)
    y_line = slope[:, None] * (tx - left[:, 0][:, None]) + left[:, 1][:, None]
    line_ok = torch.abs(y_line - ty) <= epsilon

    return in_x & torch.where(vertical, vert_ok, line_ok)


def best_target_plain(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid,
                      chunk: int = 1024):
    """(idx int32, dist float32) per query; rows with a non-finite p1.x are
    unconstrained."""
    def gate(a, b):
        return epipolar_segment_mask(a, b, t_loc, epsilon) | ~torch.isfinite(a[:, 0:1])

    return best_target_chunked(q_desc, t_desc, t_valid, mask_fn=gate, mask_aux=(p1, p2),
                               chunk=chunk)


def _check(q_desc, t_desc, t_loc, p1, p2, t_valid):
    nq, nt = q_desc.shape[0], t_desc.shape[0]
    shapes = {"q_desc": (q_desc, (nq, 128), torch.uint8),
              "t_desc": (t_desc, (nt, 128), torch.uint8),
              "t_loc": (t_loc, (nt, 2), torch.float32),
              "p1": (p1, (nq, 2), torch.float32),
              "p2": (p2, (nq, 2), torch.float32),
              "t_valid": (t_valid, (nt,), torch.bool)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != q_desc.device:
            raise ValueError(f"{name} is on {t.device}, q_desc on {q_desc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def best_target(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid):
    """Best valid target per query and its exact squared-L2 distance.

    q_desc (Nq, 128) u8, t_desc (Nt, 128) u8, t_loc (Nt, 2) f32, p1/p2
    (Nq, 2) f32 epipolar segment endpoints (p1.x = +inf: unconstrained),
    t_valid (Nt,) bool -> idx (Nq,) int32, dist (Nq,) float32 (+inf where no
    target passes).  CPU tensors take the plain version; CUDA tensors the K3
    kernel."""
    _check(q_desc, t_desc, t_loc, p1, p2, t_valid)
    if q_desc.device.type == "cpu":
        return best_target_plain(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid)
    if q_desc.device.type != "cuda":
        raise ValueError(f"best_target: unsupported device {q_desc.device}")
    for name, t in (("q_desc", q_desc), ("t_desc", t_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nq, nt = q_desc.shape[0], t_desc.shape[0]
    idx = torch.empty((nq,), dtype=torch.int32, device=q_desc.device)
    dist = torch.empty((nq,), dtype=torch.float32, device=q_desc.device)
    if nq == 0:
        return idx, dist
    rc = _cuda.library().ssrlcv_match_best(
        q_desc.data_ptr(), t_desc.data_ptr(), t_loc.data_ptr(), t_valid.data_ptr(),
        p1.data_ptr(), p2.data_ptr(), float(epsilon), nq, nt, idx.data_ptr(),
        dist.data_ptr(), _cuda.stream_ptr(q_desc.device))
    _cuda.check(rc, "ssrlcv_match_best")
    best_target.launches += 1
    return idx, dist


best_target.launches = 0
