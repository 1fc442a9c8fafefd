"""The yardstick's arithmetic: the H100's published peaks, the card record,
and the operations and bytes a kernel's work needs, counted from its
inputs whatever implements it.

Frozen copies, so a later change to the program cannot move them:
``bound``, ``K1_OPS_PER_SAMPLE`` / ``K2_OPS_PER_SAMPLE``, ``k1_samples``,
``k2_samples``, ``gated_pairs`` and ``nbytes`` from ``chip_smoke.py``
(``bound``, ``_k1_samples``, ``_k2_samples``, ``_gated_pairs``,
``_nbytes``); the peaks and ``device_record`` from
``ssrlcv_tpu_torch/bench/scene.py``.  The window formulas the sample counts
need (``window_and_denom``, ``descriptor_window``) and the gate
(``epipolar_segment_mask``) come from the plain reference.
"""

from __future__ import annotations

import subprocess

import torch

from benchmark.reference.features.desc_kernel import descriptor_window
from benchmark.reference.features.orient_kernel import window_and_denom
from benchmark.reference.matching.match_kernel import epipolar_segment_mask

# published peaks of one H100 SXM at 700 W, dense (bench/scene.py)
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
H100_INT8_PER_S = 1979e12

# fp32 operations per window sample (chip_smoke.py): K1 magnitude, exp,
# atan2, bin and add (~40); K2 ~40 of its own (rotation, rint, magnitude,
# exp, atan2, fmod) plus ~8 for each of the ~4 cells x 2 bins it feeds
K1_OPS_PER_SAMPLE = 40
K2_OPS_PER_SAMPLE = 100
# int8 operations per (query, target) pair the matcher needs: a multiply
# and an add for each of the 128 descriptor bytes
K3_OPS_PER_PAIR = 2 * 128


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time for ``nbytes`` of traffic and ``ops`` operations of
    type ``kind`` ("fp32" or "int8") at the H100's published peaks:
    {"bound_s", "bound_by"} (chip_smoke.py's ``bound``, in seconds)."""
    peak = {"fp32": H100_FP32_PER_S, "int8": H100_INT8_PER_S}[kind]
    tb, to = nbytes / H100_BYTES_PER_S, ops / peak
    return {"bound_s": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def nbytes(*tensors) -> int:
    """Bytes of the tensors, each read (or written) once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_samples(sig, pw, lam_o, w_max) -> int:
    """Window samples K1 evaluates: (2 min(win, w_max) + 1)^2 per keypoint."""
    r = torch.clamp(window_and_denom(sig, pw, lam_o)[0], max=w_max)
    return int(((2 * r + 1) ** 2).sum())


def k2_samples(theta, sig, pw, lam_d, w_max, chunk: int = 1024) -> int:
    """Window samples K2 evaluates: lattice offsets |dx|,|dy| <= min(win,
    w_max) whose rotation lies within the window, per keypoint."""
    win = descriptor_window(sig, pw, lam_d)
    offs = torch.arange(-w_max, w_max + 1, device=sig.device, dtype=torch.float32)
    dy, dx = (g.reshape(-1) for g in torch.meshgrid(offs, offs, indexing="ij"))
    n = 0
    for s0 in range(0, sig.shape[0], chunk):
        wc = win[s0:s0 + chunk, None]
        ct, st = torch.cos(theta[s0:s0 + chunk, None]), torch.sin(theta[s0:s0 + chunk, None])
        cx, cy = dx * ct - dy * st, dx * st + dy * ct
        n += int(((dx.abs() <= wc) & (dy.abs() <= wc) & (cx.abs() <= wc)
                  & (cy.abs() <= wc)).sum())
    return n


def gated_pairs(q_mask, t_valid, p1, p2, t_loc, eps) -> int:
    """(query, target) pairs the gate admits (the epipolar test, or every
    target for a row with p1.x not finite) among the queries of ``q_mask``
    and the targets of ``t_valid``: the pairs whose distance the pass
    needs."""
    rows = torch.nonzero(q_mask).squeeze(1)
    n = 0
    for s0 in range(0, rows.shape[0], 1024):
        r = rows[s0:s0 + 1024]
        gate = epipolar_segment_mask(p1[r], p2[r], t_loc, eps) | ~torch.isfinite(p1[r, 0:1])
        n += int((gate & t_valid[None, :]).sum())
    return n


def device_record() -> dict:
    """The card the run took place on: {"name", "power_limit_w", "count"},
    from ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (its first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    name, limit = (v.strip() for v in out[0].rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]), "count": len(out)}
