"""K4: epipolar-gated best target with the cross term on the tensor cores
(wrapper, plain version).

Counterpart of ``_match_prep`` + ``_match_call`` of
``ssrlcv_tpu/matching/pallas_match.py`` (the Pallas kernel
``_match_kernel``): the same best target as K3 (``match_kernel.best_target``),
with the descriptor cross term computed as a matrix product.  The CUDA kernel
is ``csrc/match_mma.cu`` (``mma.sync`` on u8 operands, so the TPU's nibble
split goes); its plain PyTorch twin is ``best_target_mma_plain``.  Nothing in
the pipeline calls it: ``best_target_mma`` is its entry point.

``best_target_mma`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu_torch import _cuda
from ssrlcv_tpu_torch.matching.match_kernel import _check, best_target_plain

NO_MATCH_DIST = 3.0e38  # K4's distance for a query with no admissible target


def gated_locations(t_loc, t_valid):
    """Target locations with +inf where ``t_valid`` is false (as
    ``_match_prep`` does): K4 admits only targets with a finite location."""
    return torch.where(t_valid[:, None], t_loc, torch.inf).contiguous()


def mma_prep(q_desc, t_desc, t_loc, t_valid):
    """What the kernel takes besides the descriptors and segments: exact
    squared norms (int32) of the queries and targets, and the gated target
    locations."""
    qn = (q_desc.to(torch.int32) ** 2).sum(1, dtype=torch.int32)
    tn = (t_desc.to(torch.int32) ** 2).sum(1, dtype=torch.int32)
    return qn, tn, gated_locations(t_loc, t_valid)


def best_target_mma_plain(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid,
                          chunk: int = 1024):
    """(idx int32, dist float32) per query under K4's output contract (see
    ``best_target_mma``)."""
    tl = gated_locations(t_loc, t_valid)
    idx, dist = best_target_plain(q_desc, t_desc, tl, p1, p2, epsilon,
                                  torch.isfinite(tl[:, 0]), chunk=chunk)
    none = torch.isinf(dist)
    return torch.where(none, 0, idx), torch.where(none, NO_MATCH_DIST, dist)


def best_target_mma(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid):
    """Best valid target per query and its exact squared-L2 distance.

    Arguments as ``match_kernel.best_target``: q_desc (Nq, 128) u8, t_desc
    (Nt, 128) u8, t_loc (Nt, 2) f32, p1/p2 (Nq, 2) f32 epipolar segment
    endpoints (p1.x = +inf: unconstrained), t_valid (Nt,) bool -> idx (Nq,)
    int32, dist (Nq,) float32.

    Output contract (K4's own): a query with an admissible target (valid,
    with a finite location, through the gate) gets the same (idx, dist) as
    K3, the exact squared L2 distance and the lowest index on ties; a query
    with none gets dist = 3.0e38 and idx = 0 (K3 gives +inf there).  CPU
    tensors take the plain version; CUDA tensors the K4 kernel."""
    _check(q_desc, t_desc, t_loc, p1, p2, t_valid)
    if q_desc.device.type == "cpu":
        return best_target_mma_plain(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid)
    if q_desc.device.type != "cuda":
        raise ValueError(f"best_target_mma: unsupported device {q_desc.device}")
    for name, t in (("q_desc", q_desc), ("t_desc", t_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nq, nt = q_desc.shape[0], t_desc.shape[0]
    idx = torch.empty((nq,), dtype=torch.int32, device=q_desc.device)
    dist = torch.empty((nq,), dtype=torch.float32, device=q_desc.device)
    if nq == 0:
        return idx, dist
    qn, tn, tl = mma_prep(q_desc, t_desc, t_loc, t_valid)
    rc = _cuda.library().ssrlcv_match_mma(
        q_desc.data_ptr(), t_desc.data_ptr(), qn.data_ptr(), tn.data_ptr(), tl.data_ptr(),
        p1.data_ptr(), p2.data_ptr(), float(epsilon), nq, nt, idx.data_ptr(),
        dist.data_ptr(), _cuda.stream_ptr(q_desc.device))
    _cuda.check(rc, "ssrlcv_match_mma")
    best_target_mma.launches += 1
    return idx, dist


best_target_mma.launches = 0
