"""Patch-gather micro-benchmark on one CUDA device (kernel K6).

    python -m ssrlcv_tpu_torch.bench.gather_patches

Counterpart of ``scripts/bench_gather2.py``: the orientation and descriptor
passes read a (K, S, S) grid of (gx, gy) samples per keypoint, and this
measures two ways of doing that at the script's shapes (B, H, W = 5, 2048,
2048 gradient planes, K = 16384 keypoints, S = 33, data from seed 0):

  A. the plain multi-dimensional gather ``grads[bi, yi, xi]`` of (K, S, S, 2)
     samples (PyTorch indexing);
  H. kernel K6 (``csrc/gather.cu``, wrapper ``patch_row_sums``): per
     keypoint an aligned (SPA, 128) patch of the packed plane, reduced to
     ``sum(|p|)`` over its rows in the lane frame.

It prints each strategy's milliseconds (CUDA events) and, for H, the rate
over the bytes the function must move (``function_bytes``: each plane
element under some key's patch read once, the keys, the output).  The
keypoints draw from planes 1..B-2 and their patches cover lanes 0..1919 of
them (47 MB), about an H100's 50 MB L2 cache, so back-to-back launches read
them largely from L2.  The script's strategies E,
F and G are TPU packing and row-gather experiments with no kernel of their
own; they are left out.

``patch_row_sums`` takes its plain version ``patch_row_sums_plain`` only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ssrlcv_tpu_torch import _cuda
from ssrlcv_tpu_torch.bench.timing import cuda_ms

B, H, W = 5, 2048, 2048
K, S = 16384, 33
LANES = 128  # output lanes per keypoint
LW = 256     # lanes of the aligned window; x0 is aligned to 128 inside it


def patch_rows(s: int) -> int:
    """Patch height: S rows plus the 8-row alignment slack."""
    return ((s + 7) // 8) * 8 + 8


def make_inputs(seed: int = 0, b: int = B, h: int = H, w: int = W, k: int = K, s: int = S,
                device="cpu") -> dict:
    """The script's data: (b, h, w, 2) float32 standard-normal gradients,
    their packed plane (``pack``), and per keypoint a plane index ``bi`` and
    an in-bounds centre (cy, cx), all from one numpy generator."""
    rng = np.random.default_rng(seed)
    grads = rng.standard_normal((b, h, w, 2), dtype=np.float32)
    wmax = s // 2
    bi = rng.integers(1, b - 1, k).astype(np.int32)
    cy = rng.integers(wmax + 1, h - wmax - 1, k).astype(np.int32)
    cx = rng.integers(wmax + 1, w - wmax - 1, k).astype(np.int32)
    out = {"grads": grads, "packed": pack(grads), "bi": bi, "cy": cy, "cx": cx}
    return {name: torch.from_numpy(a).to(device) for name, a in out.items()}


def pack(grads: np.ndarray) -> np.ndarray:
    """(..., 2) float32 -> (...) float32 whose bits carry both values as
    float16 (round to nearest even): gx in the low half, gy in the high."""
    u = grads.astype(np.float16).view(np.uint16).astype(np.uint32)
    return (u[..., 0] | (u[..., 1] << 16)).view(np.float32)


def strategy_a(grads, bi, cy, cx, s: int = S):
    """(K, S, S, 2) samples by one multi-dimensional gather."""
    offs = torch.arange(s, device=grads.device) - s // 2
    yi = cy.long()[:, None, None] + offs[None, :, None]
    xi = cx.long()[:, None, None] + offs[None, None, :]
    return grads[bi.long()[:, None, None], yi, xi]


def _origins(cy, cx, s: int, h: int, w: int):
    y0 = torch.clamp((cy - s // 2) & ~7, 0, h - patch_rows(s))
    x0 = torch.clamp((cx - LANES // 2) & ~127, 0, w - LW)
    return y0, x0


def patch_row_sums_plain(plane, bi, cy, cx, s: int = S):
    """(K, 128) float32: per keypoint, the patch rows' |values| summed in
    row order over the first 128 lanes of the aligned window."""
    _, h, w = plane.shape
    y0, x0 = _origins(cy, cx, s, h, w)
    lanes = x0.long()[:, None] + torch.arange(LANES, device=plane.device)
    b = bi.long()[:, None]
    acc = torch.zeros((bi.shape[0], LANES), dtype=torch.float32, device=plane.device)
    for r in range(patch_rows(s)):
        acc = acc + plane[b, (y0.long() + r)[:, None], lanes].abs()
    return acc


def slot_geometry(b: int, h: int, w: int, s: int) -> tuple[int, int, int]:
    """(NX, NY, slots) of csrc/gather.cu: a key's slot is (bi * NX +
    ceil(x0 / 128)) * NY + ceil(y0 / 8), one per distinct (plane, x0, y0)."""
    nx = -(-(w - LW) // 128) + 1
    ny = -(-(h - patch_rows(s)) // 8) + 1
    return nx, ny, b * nx * ny


def key_slots(bi, cy, cx, s: int, h: int, w: int):
    """Each key's slot (``slot_geometry``)."""
    nx, ny, _ = slot_geometry(0, h, w, s)
    y0, x0 = _origins(cy, cx, s, h, w)
    return (bi.long() * nx + -(-x0.long() // 128)) * ny + -(-y0.long() // 8)


def function_bytes(plane, bi, cy, cx, s: int = S) -> int:
    """The bytes ``patch_row_sums`` must move: each plane element under some
    key's (SPA, 128) patch read once, bi / cy / cx, and the (K, 128)
    float32 output."""
    b, h, w = plane.shape
    k = bi.shape[0]
    if k == 0:
        return 0
    # +1 at each patch's first row, -1 past its last, per lane; a running
    # sum down the rows is then > 0 exactly on the covered elements
    y0, x0 = _origins(cy, cx, s, h, w)
    lanes = x0.long()[:, None] + torch.arange(LANES, device=plane.device)
    planes = bi.long()[:, None].expand_as(lanes)
    ones = torch.ones(lanes.shape, dtype=torch.int32, device=plane.device)
    edges = torch.zeros((b, h + 1, w), dtype=torch.int32, device=plane.device)
    edges.index_put_((planes, y0.long()[:, None].expand_as(lanes), lanes), ones, accumulate=True)
    edges.index_put_((planes, (y0.long() + patch_rows(s))[:, None].expand_as(lanes), lanes),
                     -ones, accumulate=True)
    covered = int((torch.cumsum(edges, 1, dtype=torch.int32) > 0).sum())
    return covered * plane.element_size() + 3 * k * 4 + k * LANES * 4


def _check(plane, bi, cy, cx, s: int):
    if plane.dim() != 3:
        raise ValueError(f"plane must be (B, H, W), got {tuple(plane.shape)}")
    if plane.dtype != torch.float32:
        raise TypeError(f"plane must be float32, got {plane.dtype}")
    k = bi.shape[0]
    for name, t in (("bi", bi), ("cy", cy), ("cx", cx)):
        if tuple(t.shape) != (k,):
            raise ValueError(f"{name} must be ({k},), got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("plane", plane), ("bi", bi), ("cy", cy), ("cx", cx)):
        if t.device != plane.device:
            raise ValueError(f"{name} is on {t.device}, plane on {plane.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, w = plane.shape
    if h < patch_rows(s) or w < LW:
        raise ValueError(f"the plane must be at least {patch_rows(s)} x {LW}, got {h} x {w}")
    if plane.device.type == "cuda":
        if w % 4 or plane.data_ptr() % 16:
            raise ValueError("on the card the plane must be 16-byte aligned with W % 4 == 0 "
                             f"(W = {w})")


def patch_row_sums(plane, bi, cy, cx, s: int = S):
    """Per-keypoint patch row sums of ``plane`` (B, H, W) float32 for
    keypoints on planes ``bi`` (each in [0, B)) centred at (cy, cx), each
    (K,) int32 -> (K, 128) float32.  CPU tensors take the plain version;
    CUDA tensors the K6 kernel."""
    _check(plane, bi, cy, cx, s)
    if plane.device.type == "cpu":
        return patch_row_sums_plain(plane, bi, cy, cx, s)
    if plane.device.type != "cuda":
        raise ValueError(f"patch_row_sums: unsupported device {plane.device}")
    b, h, w = plane.shape
    k = bi.shape[0]
    out = torch.empty((k, LANES), dtype=torch.float32, device=plane.device)
    if k == 0:
        return out
    # the slots' list heads, then each key's next key (csrc/gather.cu)
    scratch = torch.empty((slot_geometry(b, h, w, s)[2] + k,), dtype=torch.int32,
                          device=plane.device)
    rc = _cuda.library().ssrlcv_patch_row_sums(
        plane.data_ptr(), b, h, w, bi.data_ptr(), cy.data_ptr(), cx.data_ptr(), k, s,
        scratch.data_ptr(), out.data_ptr(), _cuda.stream_ptr(plane.device))
    _cuda.check(rc, "ssrlcv_patch_row_sums")
    patch_row_sums.launches += 1
    return out


patch_row_sums.launches = 0


def measure(inp: dict, s: int = S, reps: int = 10) -> dict:
    """Device times of strategies A and H on ``inp`` (``make_inputs`` on a
    CUDA device); ``*_queued`` as ``timing.cuda_ms``."""
    bi, cy, cx = inp["bi"], inp["cy"], inp["cx"]
    k = bi.shape[0]
    a_ms, a_q = cuda_ms(lambda: strategy_a(inp["grads"], bi, cy, cx, s), reps)
    h_ms, h_q = cuda_ms(lambda: patch_row_sums(inp["packed"], bi, cy, cx, s), reps)
    return {"a_ms": a_ms, "a_queued": a_q, "a_melem_s": k * s * s * 2 / a_ms / 1e3,
            "h_ms": h_ms, "h_queued": h_q,
            "h_gb_s": function_bytes(inp["packed"], bi, cy, cx, s) / h_ms / 1e6}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gather_patches: needs a CUDA device")
    res = measure(make_inputs(device=torch.device("cuda:0")))
    print(f"device {torch.cuda.get_device_name(0)}; B,H,W = {B},{H},{W}, K = {K}, S = {S}")
    print(f"A multi-dim gather (f32 pairs): {res['a_ms']:8.3f} ms  "
          f"{res['a_melem_s']:7.0f} Melem/s")
    print(f"H K6 patch row sums:            {res['h_ms']:8.3f} ms  "
          f"{res['h_gb_s']:7.1f} GB/s over the bytes it must move")


if __name__ == "__main__":
    main()
