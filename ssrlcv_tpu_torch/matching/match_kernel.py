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

from typing import NamedTuple, Optional

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


QW = 16   # query rows per band interval: one warp's m16 tile in csrc/match.cu
TT = 128  # targets per tile of csrc/match.cu
_PAD_REL, _PAD_ABS = 1e-4, 1e-2  # band widening against the gate's float rounding


def _no_match(idx, dist, q_valid):
    """(0, +inf) on the rows where ``q_valid`` is false."""
    if q_valid is None:
        return idx, dist
    return torch.where(q_valid, idx, 0), torch.where(q_valid, dist, torch.inf)


def best_target_plain(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid, chunk: int = 1024,
                      q_valid=None):
    """(idx int32, dist float32) per query; rows with a non-finite p1.x are
    unconstrained; rows with ``q_valid`` false get (0, +inf)."""
    def gate(a, b, tl):
        return epipolar_segment_mask(a, b, tl, epsilon) | ~torch.isfinite(a[:, 0:1])

    return _no_match(*best_target_chunked(q_desc, t_desc, t_valid, mask_fn=gate,
                                          mask_aux=(p1, p2), t_aux=(t_loc,), chunk=chunk),
                     q_valid)


def _row_bands(p1, p2, epsilon: float, q_valid=None):
    """Per query row the y-band of ``_match_prep_i8`` -- [min(p1.y, p2.y) -
    s, max(..) + s], s = eps for a vertical segment, else eps * (1 +
    |slope|): the gate admits targets up to eps outside the segment's
    x-range along the extrapolated line -- and the gate's x-range [left.x -
    eps, right.x + eps]: (ylo, yhi, xlo, xhi), each (Nq,); (-inf, +inf) for
    unconstrained rows, the neutral (+inf, -inf) for rows with ``q_valid``
    false."""
    inf = torch.inf
    unc = ~torch.isfinite(p1[:, 0])
    dxs = torch.abs(p1[:, 0] - p2[:, 0])
    dys = torch.abs(p1[:, 1] - p2[:, 1])
    vertical = dxs == 0
    slope_abs = dys / torch.where(vertical, 1.0, dxs)
    slack = torch.where(vertical, epsilon, epsilon * (1.0 + slope_abs))
    ylo = torch.where(unc, -inf, torch.minimum(p1[:, 1], p2[:, 1]) - slack)
    yhi = torch.where(unc, inf, torch.maximum(p1[:, 1], p2[:, 1]) + slack)
    swap = p1[:, 0] >= p2[:, 0]
    xlo = torch.where(unc, -inf, torch.where(swap, p2[:, 0], p1[:, 0]) - epsilon)
    xhi = torch.where(unc, inf, torch.where(swap, p1[:, 0], p2[:, 0]) + epsilon)
    if q_valid is not None:
        ylo, xlo = (torch.where(q_valid, v, inf) for v in (ylo, xlo))
        yhi, xhi = (torch.where(q_valid, v, -inf) for v in (yhi, xhi))
    return ylo, yhi, xlo, xhi


def _per_tile(lo, hi, n):
    """(lo, hi) per ``n`` consecutive entries: (min lo, max hi); the tail
    padded with the neutral (+inf, -inf)."""
    pad = -lo.shape[0] % n
    lo = torch.nn.functional.pad(lo, (0, pad), value=torch.inf)
    hi = torch.nn.functional.pad(hi, (0, pad), value=-torch.inf)
    return torch.stack([lo.view(-1, n).amin(1), hi.view(-1, n).amax(1)], 1)


def _target_ranges(t_loc, t_valid):
    """Per target (x, y) as (lo, hi) pairs of the valid ones, the neutral
    (+inf, -inf) for the others: (xlo, xhi, ylo, yhi)."""
    inf = torch.inf
    x, y = t_loc[:, 0], t_loc[:, 1]
    return (torch.where(t_valid, x, inf), torch.where(t_valid, x, -inf),
            torch.where(t_valid, y, inf), torch.where(t_valid, y, -inf))


def spatial_order(t_loc, t_valid, p1, p2, q_valid=None):
    """The orders in which K3 tiles its operands (qperm (Nq,), tperm (Nt,)
    int64): valid targets by strips of height Y across the valid targets'
    extent, then by x, so that 128 consecutive targets cover a compact
    region (Y chosen so that a tile is about square), invalid ones last;
    queries the same way by the midpoint of their segment, unconstrained rows
    first, rows with ``q_valid`` false last.  Computed on the device, without
    a host synchronisation.  Any order gives the same answers: the kernel
    keeps the lexicographic (distance, original index) minimum."""
    x, y = t_loc[:, 0].double(), t_loc[:, 1].double()
    inf = torch.inf
    vx, vy = torch.where(t_valid, x, inf), torch.where(t_valid, y, inf)
    x0, y0 = vx.amin(), vy.amin()
    x1, y1 = torch.where(t_valid, x, -inf).amax(), torch.where(t_valid, y, -inf).amax()
    n = t_valid.sum().double()
    strip = torch.sqrt(TT * (x1 - x0 + 1.0) * (y1 - y0 + 1.0) / n.clamp(min=1.0)).clamp(min=1.0)
    strip = torch.nan_to_num(strip, nan=1.0, posinf=1.0)

    def key(px, py):
        return torch.floor((py - y0) / strip) * 1e7 + (px - x0)

    tkey = torch.where(t_valid, key(x, y), inf)
    mx = (p1[:, 0].double() + p2[:, 0].double()) / 2
    my = (p1[:, 1].double() + p2[:, 1].double()) / 2
    qkey = torch.where(torch.isfinite(p1[:, 0]), torch.nan_to_num(key(mx, my), nan=inf), -inf)
    if q_valid is not None:
        qkey = torch.where(q_valid, qkey, inf)
    return torch.argsort(qkey, stable=True), torch.argsort(tkey, stable=True)


def widen(iv):
    """Finite intervals widened by 1e-4 * max(|lo|, |hi|) + 1e-2: room for
    the float rounding of the gate's line evaluation, so that a band never
    excludes a target the gate admits.  Infinite ends stay as they are."""
    lo, hi = iv[:, 0], iv[:, 1]
    pad = _PAD_REL * torch.maximum(lo.abs(), hi.abs()) + _PAD_ABS
    fin = torch.isfinite(lo) & torch.isfinite(hi)
    return torch.stack([torch.where(fin, lo - pad, lo), torch.where(fin, hi + pad, hi)], 1)


def tile_boxes(t_loc, p1, p2, epsilon: float, t_valid, q_valid, qperm, tperm):
    """What K3 skips on, in its tile order: per 16 query slots the widened
    union of the rows' y-bands and x-ranges, (nQ, 4) as (ylo, yhi, xlo,
    xhi); per 128 target slots the y- and x-range of the valid targets,
    (nT, 4) in the same layout."""
    qp, tp = qperm.long(), tperm.long()
    ylo, yhi, xlo, xhi = (v[qp] for v in _row_bands(p1, p2, epsilon, q_valid))
    txlo, txhi, tylo, tyhi = (v[tp] for v in _target_ranges(t_loc, t_valid))
    qbox = torch.cat([widen(_per_tile(ylo, yhi, QW)), widen(_per_tile(xlo, xhi, QW))], 1)
    tbox = torch.cat([_per_tile(tylo, tyhi, TT), _per_tile(txlo, txhi, TT)], 1)
    return qbox.contiguous(), tbox.contiguous()


def live_tiles(qbox, tbox):
    """(nQ, nT) bool: the (16 query slots, 128 target slots) tiles K3
    evaluates -- a non-empty target tile whose y- and x-range meet the
    query slots' boxes."""
    q, t = qbox[:, None], tbox[None]
    return ((t[..., 0] <= t[..., 1]) & (q[..., 0] <= t[..., 1]) & (q[..., 1] >= t[..., 0])
            & (q[..., 2] <= t[..., 3]) & (q[..., 3] >= t[..., 2]))


def best_target_tiled(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid, q_valid=None,
                      chunk: int = 1024):
    """``best_target_plain`` restricted to the tiles that K3 evaluates (in
    its ``spatial_order``, ``live_tiles``): a restatement of the kernel's
    skip decisions, which give the plain version's answers when the skip is
    exact."""
    return _launch_plain(prepare_plain(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid, q_valid),
                         chunk)


def _launch_plain(prep: "Prepared", chunk: int = 1024):
    """``best_target_plain`` over the tiles of a prepared layout that pass
    ``live_tiles``."""
    live = live_tiles(prep.qbox, prep.tbox)
    dev = prep.q_desc.device
    q_warp = torch.empty_like(prep.qperm, dtype=torch.int64)
    q_warp[prep.qperm.long()] = torch.arange(prep.q_desc.shape[0], device=dev) // QW
    t_tile = torch.empty_like(prep.tperm, dtype=torch.int64)
    t_tile[prep.tperm.long()] = torch.arange(prep.t_desc.shape[0], device=dev) // TT

    def gate(a, b, w, tl, tt):
        return ((epipolar_segment_mask(a, b, tl, prep.epsilon)
                 | ~torch.isfinite(a[:, 0:1])) & live[w][:, tt])

    return _no_match(*best_target_chunked(prep.q_desc, prep.t_desc, prep.t_valid, mask_fn=gate,
                                          mask_aux=(prep.p1, prep.p2, q_warp),
                                          t_aux=(prep.t_loc, t_tile), chunk=chunk),
                     prep.q_valid)


def _check(q_desc, t_desc, t_loc, p1, p2, t_valid, q_valid=None):
    nq, nt = q_desc.shape[0], t_desc.shape[0]
    shapes = {"q_desc": (q_desc, (nq, 128), torch.uint8),
              "t_desc": (t_desc, (nt, 128), torch.uint8),
              "t_loc": (t_loc, (nt, 2), torch.float32),
              "p1": (p1, (nq, 2), torch.float32),
              "p2": (p2, (nq, 2), torch.float32),
              "t_valid": (t_valid, (nt,), torch.bool)}
    if q_valid is not None:
        shapes["q_valid"] = (q_valid, (nq,), torch.bool)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != q_desc.device:
            raise ValueError(f"{name} is on {t.device}, q_desc on {q_desc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def target_meta(t_desc, t_loc, t_valid, tperm):
    """(nT * 128, 4) float32 per target slot of K3's order ``tperm``: x, y,
    the exact squared norm of its bytes as int32 bits (-1 where t_valid is
    false and in the tail of the last tile), its original index as int32
    bits."""
    nt = t_desc.shape[0]
    tp = tperm.long()
    tn = (t_desc.to(torch.int32) ** 2).sum(1, dtype=torch.int32)
    tn = torch.where(t_valid, tn, -1)
    meta = torch.zeros((-(-nt // TT) * TT, 4), dtype=torch.int32, device=t_desc.device)
    meta[:, 2] = -1
    meta[:nt, 2] = tn[tp]
    meta[:nt, 3] = tperm.to(torch.int32)
    meta = meta.view(torch.float32)
    meta[:nt, :2] = t_loc[tp]
    return meta


def device_orders(t_loc, t_valid, p1, p2, q_valid=None):
    """``spatial_order`` on the device: the sort keys from
    ``ssrlcv_match_keys`` (match.cu), then their stable sorts -> (qperm,
    tperm)."""
    nq, nt, dev = p1.shape[0], t_loc.shape[0], t_loc.device
    ext = torch.empty((4,), dtype=torch.float64, device=dev)
    tkey = torch.empty((nt,), dtype=torch.float64, device=dev)
    qkey = torch.empty((nq,), dtype=torch.float64, device=dev)
    qv = q_valid.data_ptr() if q_valid is not None else None
    _cuda.check(_cuda.library().ssrlcv_match_keys(
        t_loc.data_ptr(), t_valid.data_ptr(), nt, p1.data_ptr(), p2.data_ptr(), qv, nq,
        ext.data_ptr(), tkey.data_ptr(), qkey.data_ptr(), _cuda.stream_ptr(dev)),
        "ssrlcv_match_keys")
    return torch.argsort(qkey, stable=True), torch.argsort(tkey, stable=True)


def layout_buffers(nq: int, nt: int, dev):
    """The device layout's tensors, filled by match.cu's ``match_layout``:
    qn (Nq,) int32, meta (nT * 128, 4) f32 (``target_meta``), qbox (nQ, 4)
    and tbox (nT, 4) f32 (``tile_boxes``)."""
    ntiles = max(-(-nt // TT), 1)
    return (torch.empty((nq,), dtype=torch.int32, device=dev),
            torch.empty((ntiles * TT, 4), dtype=torch.float32, device=dev),
            torch.empty((-(-nq // QW), 4), dtype=torch.float32, device=dev),
            torch.empty((ntiles, 4), dtype=torch.float32, device=dev))


class Prepared(NamedTuple):
    """K3's operands in its layout: the inputs, the orders (qperm, tperm),
    the squared query norms qn (Nq,) int32, ``target_meta`` and
    ``tile_boxes``."""

    q_desc: torch.Tensor
    t_desc: torch.Tensor
    t_loc: torch.Tensor
    t_valid: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    epsilon: float
    q_valid: Optional[torch.Tensor]
    qperm: torch.Tensor
    tperm: torch.Tensor
    qn: torch.Tensor
    meta: torch.Tensor
    qbox: torch.Tensor
    tbox: torch.Tensor


def prepare_plain(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid,
                  q_valid=None) -> Prepared:
    """K3's preparation restated in PyTorch (``spatial_order``,
    ``target_meta``, ``tile_boxes``), on any device."""
    qperm, tperm = spatial_order(t_loc, t_valid, p1, p2, q_valid)
    qbox, tbox = tile_boxes(t_loc, p1, p2, epsilon, t_valid, q_valid, qperm, tperm)
    return Prepared(q_desc, t_desc, t_loc, t_valid, p1, p2, float(epsilon), q_valid, qperm, tperm,
                    (q_desc.to(torch.int32) ** 2).sum(1, dtype=torch.int32),
                    target_meta(t_desc, t_loc, t_valid, tperm), qbox, tbox)


def prepare(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid, q_valid=None) -> Prepared:
    """K3's preparation, the step before its launch (``launch``): on a CUDA
    device the orders (``device_orders``), then match.cu's layout kernel
    (``ssrlcv_match_layout``) into ``layout_buffers``; for CPU tensors
    ``prepare_plain``.  Arguments as ``best_target``."""
    _check(q_desc, t_desc, t_loc, p1, p2, t_valid, q_valid)
    if q_desc.device.type == "cpu":
        return prepare_plain(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid, q_valid)
    if q_desc.device.type != "cuda":
        raise ValueError(f"best_target: unsupported device {q_desc.device}")
    for name, t in (("q_desc", q_desc), ("t_desc", t_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nq, nt, dev = q_desc.shape[0], t_desc.shape[0], q_desc.device
    qperm, tperm = device_orders(t_loc, t_valid, p1, p2, q_valid)
    layout = layout_buffers(nq, nt, dev)
    qv = q_valid.data_ptr() if q_valid is not None else None
    _cuda.check(_cuda.library().ssrlcv_match_layout(
        q_desc.data_ptr(), t_desc.data_ptr(), t_loc.data_ptr(), t_valid.data_ptr(),
        p1.data_ptr(), p2.data_ptr(), qv, qperm.data_ptr(), tperm.data_ptr(), float(epsilon),
        nq, nt, *(b.data_ptr() for b in layout), _cuda.stream_ptr(dev)), "ssrlcv_match_layout")
    return Prepared(q_desc, t_desc, t_loc, t_valid, p1, p2, float(epsilon), q_valid, qperm, tperm,
                    *layout)


def launch(prep: Prepared):
    """K3 on a prepared layout -> (idx, dist) as ``best_target``: on a CUDA
    device the kernel (``ssrlcv_match_run``), for CPU tensors the plain
    version over the layout's tiles (``best_target_tiled``'s answer)."""
    q_desc = prep.q_desc
    if q_desc.device.type == "cpu":
        return _launch_plain(prep)
    nq, nt, dev = q_desc.shape[0], prep.t_desc.shape[0], q_desc.device
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    dist = torch.empty((nq,), dtype=torch.float32, device=dev)
    if nq == 0:
        return idx, dist
    scratch = torch.empty((nq,), dtype=torch.int64, device=dev)
    qv = prep.q_valid.data_ptr() if prep.q_valid is not None else None
    rc = _cuda.library().ssrlcv_match_run(
        q_desc.data_ptr(), prep.t_desc.data_ptr(), qv, prep.p1.data_ptr(), prep.p2.data_ptr(),
        prep.qperm.data_ptr(), prep.tperm.data_ptr(), prep.epsilon, nq, nt,
        *(b.data_ptr() for b in (prep.qn, prep.meta, prep.qbox, prep.tbox)), scratch.data_ptr(),
        idx.data_ptr(), dist.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(rc, "ssrlcv_match_run")
    best_target.launches += 1
    return idx, dist


def best_target(q_desc, t_desc, t_loc, p1, p2, epsilon: float, t_valid, q_valid=None):
    """Best valid target per query and its exact squared-L2 distance.

    q_desc (Nq, 128) u8, t_desc (Nt, 128) u8, t_loc (Nt, 2) f32, p1/p2
    (Nq, 2) f32 epipolar segment endpoints (p1.x = +inf: unconstrained),
    t_valid (Nt,) bool, q_valid (Nq,) bool or None (every row) -> idx (Nq,)
    int32, dist (Nq,) float32; (0, +inf) where no target passes or q_valid
    is false.  CPU tensors take the plain version; CUDA tensors the K3
    kernel (step 1: the orders; step 2: the layout, then the matcher)."""
    _check(q_desc, t_desc, t_loc, p1, p2, t_valid, q_valid)
    if q_desc.device.type == "cpu":
        return best_target_plain(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid,
                                 q_valid=q_valid)
    return launch(prepare(q_desc, t_desc, t_loc, p1, p2, epsilon, t_valid, q_valid))


best_target.launches = 0
