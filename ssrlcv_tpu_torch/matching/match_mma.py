"""K4: epipolar-gated best target with the cross term on the tensor cores
(wrapper, plain version).

Counterpart of ``_match_prep`` + ``_match_call`` of
``ssrlcv_tpu/matching/pallas_match.py`` (the Pallas kernel
``_match_kernel``): the same best target as K3 (``match_kernel.best_target``),
with the descriptor cross term computed as a matrix product, answered for
every query row.  The CUDA kernel is ``csrc/match_mma.cu`` (``mma.sync`` on
u8 operands, so the TPU's nibble split goes); its plain PyTorch twin is
``best_target_mma_plain``, and ``best_target_mma_tiled`` restates the
kernel's tile schedule and packed-key tie rule.  Nothing in the pipeline
calls it: ``best_target_mma`` is its entry point.

``best_target_mma`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu_torch import _cuda
from ssrlcv_tpu_torch.matching.match_kernel import (QW, TT, _check, best_target_plain,
                                                    device_orders, epipolar_segment_mask,
                                                    layout_buffers, live_tiles, spatial_order,
                                                    tile_boxes)

NO_MATCH_DIST = 3.0e38  # K4's distance for a query with no admissible target
INT_MAX = 2 ** 31 - 1   # the key of a slot with no admissible target


def gated_locations(t_loc, t_valid):
    """Target locations with +inf where ``t_valid`` is false (as
    ``_match_prep`` does): K4 admits only targets with a finite location."""
    return torch.where(t_valid[:, None], t_loc, torch.inf).contiguous()


def admissible(t_loc, t_valid):
    """(Nt,) bool: the targets K4 may return -- valid, with a finite x (the
    finite entries of ``gated_locations``)."""
    return (t_valid & torch.isfinite(t_loc[:, 0])).contiguous()


def best_target_mma_plain(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid,
                          chunk: int = 1024):
    """(idx int32, dist float32) per query under K4's output contract (see
    ``best_target_mma``)."""
    tl = gated_locations(t_loc, t_valid)
    idx, dist = best_target_plain(q_desc, t_desc, tl, p1, p2, epsilon,
                                  torch.isfinite(tl[:, 0]), chunk=chunk)
    none = torch.isinf(dist)
    return torch.where(none, 0, idx), torch.where(none, NO_MATCH_DIST, dist)


def tile_sorted(tperm):
    """K4's target order: K3's tiles of ``TT`` slots (``spatial_order``),
    each tile's slots in increasing original index.  Tile membership, and so
    the tiles' boxes, stay K3's."""
    nt = tperm.shape[0]
    pad = torch.full((-nt % TT,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                     device=tperm.device)
    return torch.cat([tperm, pad]).view(-1, TT).sort(dim=1).values.reshape(-1)[:nt]


def best_target_mma_tiled(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid,
                          chunk: int = 1024):
    """``best_target_mma`` restated as K4 computes it: K3's spatial order
    with every row live, each tile's slots by original index
    (``tile_sorted``), only the (16-row, 128-target) tiles that ``live_tiles``
    keeps; within a tile the minimum of the int32 key 128 |t|^2 + slot -
    256 q.t (INT_MAX and a zeroed descriptor for a slot with no admissible
    target) over the pairs the gate admits, plus 128 |q|^2 once a tile,
    unpacked to (d, slot -> original index); across tiles the
    lexicographic (d, index) minimum.  (0, 3.0e38) where no tile gave a
    key."""
    adm = admissible(t_loc, t_valid)
    qperm, tperm = spatial_order(t_loc, adm, p1, p2)
    tperm = tile_sorted(tperm)
    live = live_tiles(*tile_boxes(t_loc, p1, p2, epsilon, adm, None, qperm, tperm))
    dev = q_desc.device
    nq, nt = q_desc.shape[0], t_desc.shape[0]
    ntiles = -(-nt // TT)
    q_warp = torch.empty((nq,), dtype=torch.int64, device=dev)
    q_warp[qperm] = torch.arange(nq, device=dev) // QW
    slot = torch.arange(nt, device=dev)
    ok_t = adm[tperm]
    tn = (t_desc[tperm].to(torch.int32) ** 2).sum(1, dtype=torch.int32)
    key = torch.where(ok_t, tn * TT + (slot % TT).to(torch.int32), INT_MAX).to(torch.int32)
    key = torch.nn.functional.pad(key, (0, ntiles * TT - nt), value=INT_MAX)
    tz = torch.where(ok_t[:, None], t_desc[tperm], 0).double()
    qn128 = (q_desc.to(torch.int32) ** 2).sum(1, dtype=torch.int32) * TT
    tl = t_loc[tperm]
    packed = []
    for s in range(0, nq, chunk):
        a, b = p1[s:s + chunk], p2[s:s + chunk]
        cross = torch.nn.functional.pad((q_desc[s:s + chunk].double() @ tz.T).to(torch.int32),
                                        (0, ntiles * TT - nt))
        k = key[None, :] - 256 * cross  # wrapping int32, as the kernel's IMAD
        gate = epipolar_segment_mask(a, b, tl, epsilon) | ~torch.isfinite(a[:, 0:1])
        gate = torch.nn.functional.pad(gate, (0, ntiles * TT - nt))
        gate = gate & live[q_warp[s:s + chunk]].repeat_interleave(TT, dim=1)
        m = torch.where(gate, k, INT_MAX).view(-1, ntiles, TT).amin(2)  # per tile
        none = m == INT_MAX  # checked before 128 |q|^2 is added: the sum would overflow
        v = torch.where(none, 0, m) + qn128[s:s + chunk, None]
        d, j = v >> 7, v & (TT - 1)
        tix = torch.arange(ntiles, device=dev)[None, :] * TT + j.long()
        idx = tperm[tix.clamp(max=nt - 1)]
        p = (d.long() << 32) | idx
        packed.append(torch.where(none, torch.iinfo(torch.int64).max, p).amin(1))
    best = torch.cat(packed) if packed else torch.zeros((0,), dtype=torch.int64, device=dev)
    nomatch = best == torch.iinfo(torch.int64).max
    return (torch.where(nomatch, 0, best & 0xFFFFFFFF).to(torch.int32),
            torch.where(nomatch, NO_MATCH_DIST, (best >> 32).to(torch.float32)))


def best_target_mma(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid):
    """Best valid target per query and its exact squared-L2 distance.

    Arguments as ``match_kernel.best_target``: q_desc (Nq, 128) u8, t_desc
    (Nt, 128) u8, t_loc (Nt, 2) f32, p1/p2 (Nq, 2) f32 epipolar segment
    endpoints (p1.x = +inf: unconstrained), t_valid (Nt,) bool -> idx (Nq,)
    int32, dist (Nq,) float32.

    Output contract (K4's own): every row is answered.  A query with an
    admissible target (valid, with a finite location, through the gate) gets
    the same (idx, dist) as K3, the exact squared L2 distance and the lowest
    index on ties; a query with none gets dist = 3.0e38 and idx = 0 (K3
    gives +inf there).  CPU tensors take the plain version; CUDA tensors the
    K4 kernel, after K3's device preparation (``ssrlcv_match_keys``,
    ``ssrlcv_match_layout``) with every row live."""
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
    dev, lib, stream = q_desc.device, _cuda.library(), _cuda.stream_ptr(q_desc.device)
    adm = admissible(t_loc, t_valid)
    # K3's orders and layout with every row live, each tile by original index
    qperm, tperm = device_orders(t_loc, adm, p1, p2)
    tperm = tile_sorted(tperm)
    qn, meta, qbox, tbox = layout_buffers(nq, nt, dev)
    _cuda.check(lib.ssrlcv_match_layout(
        q_desc.data_ptr(), t_desc.data_ptr(), t_loc.data_ptr(), adm.data_ptr(), p1.data_ptr(),
        p2.data_ptr(), None, qperm.data_ptr(), tperm.data_ptr(), float(epsilon), nq, nt,
        qn.data_ptr(), meta.data_ptr(), qbox.data_ptr(), tbox.data_ptr(), stream),
        "ssrlcv_match_layout")
    scratch = torch.empty((nq,), dtype=torch.int64, device=dev)
    rc = lib.ssrlcv_match_mma(
        q_desc.data_ptr(), t_desc.data_ptr(), qn.data_ptr(), meta.data_ptr(), p1.data_ptr(),
        p2.data_ptr(), qperm.data_ptr(), tperm.data_ptr(), qbox.data_ptr(), tbox.data_ptr(),
        float(epsilon), nq, nt, scratch.data_ptr(), idx.data_ptr(), dist.data_ptr(), stream)
    _cuda.check(rc, "ssrlcv_match_mma")
    best_target_mma.launches += 1
    return idx, dist


best_target_mma.launches = 0
