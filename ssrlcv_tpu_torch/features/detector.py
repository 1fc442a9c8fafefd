"""DoG keypoint detection: extrema search, subpixel refinement, rejection.

Counterpart of ``ssrlcv_tpu/features/detector.py``.  Keypoints live in a
fixed-capacity masked struct-of-arrays; each rejection pass clears mask bits.
The Newton refinement keeps the reference's non-standard diagonal Hessian
(H00 = g0 - 2*M) and the edge test its un-divided off-diagonal term.

``find_keypoints_octave`` takes the plain chain below for CPU tensors and,
for CUDA tensors, the two kernels of ``csrc/detect.cu``
(``detect_kernel.detect_keypoints``), equal to it bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssrlcv_tpu_torch.config import SIFTParams
from ssrlcv_tpu_torch.features.detect_kernel import detect_keypoints


class SSKeyPoints(NamedTuple):
    """Masked fixed-capacity scale-space keypoints of one octave."""

    blur: torch.Tensor       # (K,) int64 DoG slice index
    loc: torch.Tensor        # (K, 2) float32 octave pixel coords (x, y)
    intensity: torch.Tensor  # (K,) float32
    sigma: torch.Tensor      # (K,) float32
    theta: torch.Tensor      # (K,) float32 (filled by orientation)
    mask: torch.Tensor       # (K,) bool

    @property
    def capacity(self) -> int:
        return self.blur.shape[0]

    def select(self, idx: torch.Tensor) -> "SSKeyPoints":
        """The keypoints at ``idx`` (an index tensor), in that order."""
        return SSKeyPoints(*(f[idx] for f in self))


def detect_extrema(dog_raw: torch.Tensor, sigmas: tuple, capacity: int,
                   prefilter_threshold: float = 0.0) -> SSKeyPoints:
    """3x3x3 extrema over interior pixels of DoG slices 1..B-2 (ties count
    as extrema), optionally with the first noise rejection |v| >= t applied
    before extraction.  Order is blur-major, then row-major pixel index; the
    first ``capacity`` extrema are kept, and ``detect_extrema.dropped``
    counts the others (from ``torch.nonzero``'s count, which the host holds).

    The JAX package selects through a hierarchical 1024-px segment sort that
    keeps at most 128 extrema per segment; ``torch.nonzero`` keeps them all,
    which equals the JAX output wherever no segment holds more than 128."""
    b, h, w = dog_raw.shape

    def axis3(op, a, dim):
        n = a.shape[dim]
        return op(a.narrow(dim, 0, n - 2), op(a.narrow(dim, 1, n - 2), a.narrow(dim, 2, n - 2)))

    def win3(op, a):
        return axis3(op, axis3(op, axis3(op, a, 2), 1), 0)

    nmax = win3(torch.maximum, dog_raw)
    nmin = win3(torch.minimum, dog_raw)
    mid = dog_raw[1:b - 1, 1:h - 1, 1:w - 1]
    is_ext = (mid == nmax) | (mid == nmin)
    if prefilter_threshold > 0.0:
        is_ext = is_ext & (torch.abs(mid) >= prefilter_threshold)

    found = torch.nonzero(is_ext.reshape(-1)).squeeze(1)
    detect_extrema.dropped += max(found.shape[0] - capacity, 0)
    found = found[:capacity]
    n = found.shape[0]
    idx = torch.zeros((capacity,), dtype=torch.int64, device=dog_raw.device)
    idx[:n] = found
    valid = torch.arange(capacity, device=dog_raw.device) < n
    per = (h - 2) * (w - 2)
    blur = idx // per + 1
    rem = idx % per
    y = rem // (w - 2) + 1
    x = rem % (w - 2) + 1
    intensity = dog_raw[blur, y, x]
    sig = torch.as_tensor(sigmas, dtype=dog_raw.dtype, device=dog_raw.device)[blur]
    return SSKeyPoints(
        blur=blur,
        loc=torch.stack([x, y], dim=-1).to(torch.float32),
        intensity=torch.where(valid, intensity, 0.0),
        sigma=sig,
        theta=torch.full((capacity,), -1.0, dtype=torch.float32, device=dog_raw.device),
        mask=valid,
    )


# extrema past ``capacity``, over every detect_extrema call
detect_extrema.dropped = 0


def remove_noise(kps: SSKeyPoints, threshold: float) -> SSKeyPoints:
    """|intensity| < threshold -> discard."""
    return kps._replace(mask=kps.mask & (torch.abs(kps.intensity) >= threshold))


def _dense_newton_fields(dog_norm: torch.Tensor):
    """Per-position Newton quantities (o0, o1, o2, gHg) for every interior
    position (blur 1..B-2, y/x 1..dim-2), each (B-2, H-2, W-2) float32, with
    the reference's non-standard diagonal Hessian."""
    mid = dog_norm[1:-1]
    up = dog_norm[2:]
    lo = dog_norm[:-2]
    h, w = dog_norm.shape[1], dog_norm.shape[2]

    def s(a, dy, dx):
        return a[:, 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]

    m = s(mid, 0, 0)
    g0 = s(mid, 0, 1) - s(mid, 0, -1)
    g1 = s(mid, 1, 0) - s(mid, -1, 0)
    g2 = s(up, 0, 0) - s(lo, 0, 0)
    h00 = -(g0 - 2.0 * m)
    h11 = -(g1 - 2.0 * m)
    h22 = -(g2 - 2.0 * m)
    h01 = -((s(mid, 1, 1) - s(mid, -1, 1) - s(mid, 1, -1) + s(mid, -1, -1)) / 4.0)
    h02 = -((s(up, 0, 1) - s(lo, 0, 1) - s(up, 0, -1) + s(lo, 0, -1)) / 4.0)
    h12 = -((s(up, 1, 0) - s(lo, 1, 0) - s(up, -1, 0) + s(lo, -1, 0)) / 4.0)

    det = (
        h00 * (h11 * h22 - h12 * h12)
        - h01 * (h01 * h22 - h12 * h02)
        + h02 * (h01 * h12 - h11 * h02)
    )
    inv_det = torch.where(torch.abs(det) > 0, 1.0 / det, torch.inf)
    a00 = h11 * h22 - h12 * h12
    a01 = h02 * h12 - h01 * h22
    a02 = h01 * h12 - h02 * h11
    a11 = h00 * h22 - h02 * h02
    a12 = h01 * h02 - h00 * h12
    a22 = h00 * h11 - h01 * h01
    o0 = (a00 * g0 + a01 * g1 + a02 * g2) * inv_det
    o1 = (a01 * g0 + a11 * g1 + a12 * g2) * inv_det
    o2 = (a02 * g0 + a12 * g1 + a22 * g2) * inv_det
    gHg = (
        g0 * (h00 * g0 + h01 * g1 + h02 * g2)
        + g1 * (h01 * g0 + h11 * g1 + h12 * g2)
        + g2 * (h02 * g0 + h12 * g1 + h22 * g2)
    )
    return o0, o1, o2, gHg


def refine_keypoints(kps: SSKeyPoints, dog_norm: torch.Tensor, sigma_min: float,
                     blur_multiplier: float, max_attempts: int = 5) -> SSKeyPoints:
    """Iterative 3-D quadratic subpixel refinement over the normalised DoG,
    vectorised over the keypoint capacity; each attempt gathers four
    precomputed Newton-field values per keypoint."""
    nblurs, h, w = dog_norm.shape
    f_o0, f_o1, f_o2, f_gHg = (f.reshape(-1) for f in _dense_newton_fields(dog_norm))
    hw = (h - 2) * (w - 2)
    nf = f_o0.shape[0]

    x = torch.round(kps.loc[:, 0]).to(torch.int64)
    y = torch.round(kps.loc[:, 1]).to(torch.int64)
    blur, loc_f, sigma, inten = kps.blur, kps.loc, kps.sigma, kps.intensity
    discard = ~kps.mask
    done = ~kps.mask

    def sgn(o):
        return torch.where(torch.abs(o) > 0.5, torch.where(o > 0, 1, -1), 0)

    for _ in range(max_attempts):
        fi = torch.clamp((blur - 1) * hw + (y - 1) * (w - 2) + (x - 1), 0, nf - 1)
        o0, o1, o2, gHg = f_o0[fi], f_o1[fi], f_o2[fi], f_gHg[fi]

        finite = torch.isfinite(o0) & torch.isfinite(o1) & torch.isfinite(o2)
        accept = finite & (torch.abs(o0) <= 0.5) & (torch.abs(o1) <= 0.5) & (torch.abs(o2) <= 0.5)

        # accept branch
        nlx = x.to(torch.float32) + o0
        nly = y.to(torch.float32) + o1
        nx = torch.round(nlx).to(torch.int64)
        ny = torch.round(nly).to(torch.int64)
        on_border_a = (nx <= 0) | (ny <= 0) | (nx >= w - 1) | (ny >= h - 1)
        nxc = torch.clamp(nx, 0, w - 1)
        nyc = torch.clamp(ny, 0, h - 1)
        new_int = dog_norm[blur, nyc, nxc] - 0.5 * gHg
        new_sigma = sigma_min * torch.pow(blur_multiplier, blur.to(torch.float32) + o2)

        # move branch
        mx = x + sgn(o0)
        my = y + sgn(o1)
        blur_m = blur + sgn(o2)
        dead_m = ((blur_m >= nblurs - 1) | (blur_m <= 0)
                  | (mx <= 0) | (my <= 0) | (mx >= w - 1) | (my >= h - 1))

        x2 = torch.where(accept, nx, mx)
        y2 = torch.where(accept, ny, my)
        blur2 = torch.where(accept, blur, blur_m)
        loc2 = torch.where(accept[:, None], torch.stack([nlx, nly], dim=1),
                           torch.stack([mx, my], dim=1).to(torch.float32))
        sigma2 = torch.where(accept, new_sigma, sigma)
        int2 = torch.where(accept & ~on_border_a, new_int, inten)
        discard2 = torch.where(accept, on_border_a, dead_m)
        done2 = accept | dead_m

        x = torch.where(done, x, x2)
        y = torch.where(done, y, y2)
        blur = torch.where(done, blur, blur2)
        loc_f = torch.where(done[:, None], loc_f, loc2)
        sigma = torch.where(done, sigma, sigma2)
        inten = torch.where(done, inten, int2)
        discard = torch.where(done, discard, discard2)
        done = done | done2

    # attempts exhausted without acceptance -> discard
    discard = discard | ~done
    return SSKeyPoints(blur=blur, loc=loc_f, intensity=inten, sigma=sigma,
                       theta=kps.theta, mask=~discard & kps.mask)


def remove_edges(kps: SSKeyPoints, dog_norm: torch.Tensor, threshold: float) -> SSKeyPoints:
    """2x2 Hessian edgeness rejection (off-diagonal not divided by 4, as the
    reference), computed densely then gathered once per keypoint."""
    nb, h, w = dog_norm.shape

    def s(a, dy, dx):
        return a[:, 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]

    m = s(dog_norm, 0, 0)
    h00 = -2.0 * m + s(dog_norm, 0, 1) + s(dog_norm, 0, -1)
    h11 = -2.0 * m + s(dog_norm, 1, 0) + s(dog_norm, -1, 0)
    h01 = (s(dog_norm, 1, 1) - s(dog_norm, -1, 1)
           - s(dog_norm, 1, -1) + s(dog_norm, -1, -1))
    tr = h00 + h11
    det = h00 * h11 - h01 * h01
    edgeness = (tr * tr / det).reshape(-1)

    x = torch.clamp(torch.round(kps.loc[:, 0]).to(torch.int64), 1, w - 2)
    y = torch.clamp(torch.round(kps.loc[:, 1]).to(torch.int64), 1, h - 2)
    hw = (h - 2) * (w - 2)
    e = edgeness[kps.blur * hw + (y - 1) * (w - 2) + (x - 1)]
    return kps._replace(mask=kps.mask & ~(e > threshold))


def check_descriptor_border(kps: SSKeyPoints, image_size: tuple[int, int],
                            lambda_desc: float, pixel_width: float) -> SSKeyPoints:
    """Drop keypoints whose descriptor window (sigma*lambda/pw, not ceil'd)
    leaves the image."""
    h, w = image_size
    ww = kps.sigma * lambda_desc / pixel_width
    keep = (
        kps.mask
        & (kps.loc[:, 0] - ww >= 0.0)
        & (kps.loc[:, 1] - ww >= 0.0)
        & (kps.loc[:, 0] + ww < w - 1)
        & (kps.loc[:, 1] + ww < h - 1)
    )
    return kps._replace(mask=keep)


def find_keypoints_octave_plain(dog_raw: torch.Tensor, dog_norm: torch.Tensor, sigmas: tuple,
                                params: SIFTParams, capacity: int) -> SSKeyPoints:
    """Per-octave detection in reference order: extrema(raw) with the 0.8t
    noise rejection fused in -> subpixel refine(norm) -> noise(t, refined
    intensity) -> edges(norm)."""
    kps = detect_extrema(dog_raw, sigmas, capacity,
                         prefilter_threshold=params.noise_threshold * 0.8)
    if params.subpixel:
        kps = refine_keypoints(
            kps, dog_norm,
            sigma_min=float(sigmas[0]),
            blur_multiplier=float(sigmas[1]) / float(sigmas[0]),
            max_attempts=params.max_refine_attempts,
        )
        kps = remove_noise(kps, params.noise_threshold)
    return remove_edges(kps, dog_norm, params.edge_threshold)


def find_keypoints_octave(dog_raw: torch.Tensor, dog_norm: torch.Tensor, sigmas: tuple,
                          params: SIFTParams, capacity: int, pixel_width=None) -> SSKeyPoints:
    """``find_keypoints_octave_plain``, then, given the octave's
    ``pixel_width``, ``check_descriptor_border``.  CPU tensors take that
    chain; CUDA tensors the detection kernels (``csrc/detect.cu``: two
    launches and one ``torch.nonzero``, bit-identical), which add the extrema
    past ``capacity`` to ``detect_extrema.dropped`` as the chain does."""
    if dog_raw.device.type != "cpu":
        fields, found = detect_keypoints(dog_raw, dog_norm, sigmas, params, capacity,
                                         pixel_width)
        detect_extrema.dropped += max(found - capacity, 0)
        return SSKeyPoints(*fields)
    kps = find_keypoints_octave_plain(dog_raw, dog_norm, sigmas, params, capacity)
    if pixel_width is None:
        return kps
    return check_descriptor_border(kps, tuple(dog_raw.shape[1:]),
                                   params.descriptor_contrib_width, pixel_width)
