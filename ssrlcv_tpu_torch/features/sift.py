"""SIFT feature generation: the full front end.

Counterpart of ``ssrlcv_tpu/features/sift.py`` in its count-exact kernel
form: DoG scale space -> per-octave detection (first ``octave_capacity``
extrema) -> descriptor-border check -> per (octave, blur bucket 1..B-3):
compact the bucket's keypoints, orientations (K1) with the bucket's window,
compact the oriented copies, descriptors (K2) -> aggregation in octave ->
blur -> detection order, truncated at ``max_keypoints``, into one
fixed-capacity FeatureSet.

Live counts come from ``torch.nonzero``, so no bucket saturates and no
keypoint is dropped short of ``max_keypoints`` (the behaviour of the JAX
package's kernel path; its CPU gather path would saturate at static bucket
capacities instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ssrlcv_tpu_torch.config import SIFTParams
from ssrlcv_tpu_torch.core.device import as_device_tensor
from ssrlcv_tpu_torch.core.types import FeatureSet
from ssrlcv_tpu_torch.features import scale_space as ss
from ssrlcv_tpu_torch.features.descriptor import fill_descriptors
from ssrlcv_tpu_torch.features.detector import detect_extrema, find_keypoints_octave
from ssrlcv_tpu_torch.features.orientation import compute_orientations
from ssrlcv_tpu_torch.logging import logger
from ssrlcv_tpu_torch.ops import image_ops as ops


def octave_capacity(params: SIFTParams, octave_index: int, height: int, width: int) -> int:
    """Detection capacity per octave: 1/64 of the octave's pixel count, at
    least 1024, rounded up to a multiple of 128."""
    scale = 2.0 ** (params.starting_octave + octave_index)
    npix = int(height * width / (scale * scale))
    cap = max(1024, npix // 64)
    return ((cap + 127) // 128) * 128


def _bucket_windows(params: SIFTParams, blur: int) -> tuple[int, int]:
    """Orientation/descriptor window bounds for keypoints of one DoG blur
    bucket: sigma/pixel_width <= (initial/0.5) * mult^(blur + 0.5) in every
    octave (refinement moves sigma by at most half a blur)."""
    ratio = (params.initial_sigma / 0.5) * params.blur_sigma_multiplier ** (blur + 0.5)
    w_o = int(math.ceil(3.0 * params.orientation_contrib_width * ratio))
    w_d = int(math.ceil(params.descriptor_contrib_width * ratio))
    return w_o, w_d


def _describe_buckets(params: SIFTParams):
    """DoG blur slices that can carry extrema: 1 .. B-3."""
    return range(1, params.blurs_per_octave - 2)


def detect_octave(octave, params: SIFTParams, o: int, height: int, width: int):
    """Octave ``o``'s keypoints: the first ``octave_capacity`` extrema of its
    DoG, refined, then the descriptor-border check."""
    sigmas = tuple(ss.octave_sigmas(params, o))[: params.blurs_per_octave - 1]
    pixel_width = float(2.0 ** (params.starting_octave + o))
    return find_keypoints_octave(octave.dog_raw, octave.dog_norm, sigmas, params,
                                 octave_capacity(params, o, height, width), pixel_width)


def _bucket_keypoints(kps, b: int):
    """The keypoints of DoG blur bucket ``b``, compacted."""
    return kps.select(torch.nonzero(kps.mask & (kps.blur == b)).squeeze(1))


def _describe_bucket(sel, gx, gy, params: SIFTParams, b: int, pixel_width: float):
    """One blur bucket's compacted keypoints on its gradient plane:
    orientations (K1) -> compact -> descriptors (K2).  Returns the oriented
    keypoints and their (loc_image, sigma, theta, desc) in emission order."""
    w_o, w_d = _bucket_windows(params, b)
    oriented = compute_orientations(gx, gy, sel, pixel_width, params, w_max=w_o)
    oriented = oriented.select(torch.nonzero(oriented.mask).squeeze(1))
    desc, loc_image = fill_descriptors(gx, gy, oriented, pixel_width, params, w_max=w_d)
    return oriented, (loc_image, oriented.sigma, oriented.theta, desc)


def _no_mark(key, value):
    pass


def generate_features(pixels, params: Optional[SIFTParams] = None, image_id: int = -1,
                      device=None, mark=None) -> FeatureSet:
    """SIFT features of one grayscale (or RGB) uint8 image, on ``device``
    (when None: the device of ``pixels`` if it is a tensor, else
    ``cuda:0``, which raises without a card).  Returns a FeatureSet of capacity ``max_keypoints``
    ordered (octave, blur bucket, detection order).

    ``mark``, when given, is called after each part of the work as
    ``mark(key, value)``: ``("scale_space_s",)`` with the octaves; per
    octave ``o`` ``(o, "detect_s")`` with its keypoints and ``(o,
    "grads_s")`` with its gradient planes (gx, gy); per blur bucket ``b``
    ``(o, b, "compact_s")`` with its compacted keypoints and ``(o, b,
    "describe_s")`` with ``_describe_bucket``'s result; last
    ``("aggregate_s",)`` with the FeatureSet (``bench.profile_sift``).

    The call is the span ``sift``, with ``sift.scale_space``, then per
    octave ``sift.detect`` and ``sift.describe`` (gradients, bucket
    compaction, K1, K2), then ``sift.aggregate`` (the concatenation and the
    copy into the capacity) inside it, at the same boundaries as ``mark``.

    Counters over every call: ``generate_features.calls``, ``.features``
    (valid features kept) and ``.dropped`` (valid features cut at
    ``max_keypoints`` plus extrema cut at an octave's ``octave_capacity``),
    from counts the host already holds."""
    with logger.span("sift"):
        return _generate_features(pixels, params or SIFTParams(), image_id, device,
                                  mark or _no_mark)


def _generate_features(pixels, params: SIFTParams, image_id: int, device, mark) -> FeatureSet:
    px = as_device_tensor(pixels, device)
    device = px.device
    if px.ndim == 3:
        px = ops.to_bw(px)
    h, w = int(px.shape[0]), int(px.shape[1])
    extrema_dropped = detect_extrema.dropped

    with logger.span("sift.scale_space"):
        octaves = ss.build_scale_space(px, params, h, w)
    mark(("scale_space_s",), octaves)
    parts = []
    for o, octave in enumerate(octaves):
        pixel_width = float(2.0 ** (params.starting_octave + o))
        with logger.span("sift.detect"):
            kps = detect_octave(octave, params, o, h, w)
        mark((o, "detect_s"), kps)
        with logger.span("sift.describe"):
            gx, gy = ops.pixel_gradients(octave.dog_norm)
            mark((o, "grads_s"), (gx, gy))
            for b in _describe_buckets(params):
                sel = _bucket_keypoints(kps, b)
                mark((o, b, "compact_s"), sel)
                described = _describe_bucket(sel, gx[b], gy[b], params, b, pixel_width)
                mark((o, b, "describe_s"), described)
                parts.append(described[1])

    with logger.span("sift.aggregate"):
        loc = torch.cat([p[0] for p in parts])
        sigma = torch.cat([p[1] for p in parts])
        theta = torch.cat([p[2] for p in parts])
        desc = torch.cat([p[3] for p in parts])
        cap = params.max_keypoints
        found = loc.shape[0]
        n = min(found, cap)
        if found > cap:
            logger.warn(f"image {image_id}: {found} valid features exceed max_keypoints={cap} — "
                        "tail dropped by global aggregation; raise SIFTParams.max_keypoints")
        out = FeatureSet.empty(cap, parent=image_id, device=device)
        out.loc[:n] = loc[:n]
        out.sigma[:n] = sigma[:n]
        out.theta[:n] = theta[:n]
        out.descriptors[:n] = desc[:n]
        out.mask[:n] = True
    generate_features.calls += 1
    generate_features.features += n
    generate_features.dropped += found - n + detect_extrema.dropped - extrema_dropped
    mark(("aggregate_s",), out)
    return out


# calls, valid features kept and features dropped (past max_keypoints or an
# octave's capacity) by every generate_features call
generate_features.calls = 0
generate_features.features = 0
generate_features.dropped = 0


def generate_features_many(pixel_list, params: Optional[SIFTParams] = None,
                           image_ids: Optional[list] = None, device=None) -> list:
    """SIFT features of several images, one after another on ``device``
    (as ``generate_features``)."""
    ids = list(image_ids) if image_ids is not None else list(range(len(pixel_list)))
    if len(ids) != len(pixel_list):
        raise ValueError(f"generate_features_many: {len(pixel_list)} images but "
                         f"{len(ids)} image_ids")
    return [generate_features(p, params, image_id=i, device=device)
            for p, i in zip(pixel_list, ids)]


def features_from_refdata(feat_dict: dict, capacity: Optional[int] = None, parent: int = -1,
                          device=None) -> FeatureSet:
    """A FeatureSet on ``device`` (None: ``cuda:0``) from a feature dump
    ({'loc', 'sigma', 'theta', 'values', 'parent'} arrays, as
    ``io.refdata`` and ``io.anatomy.read_features`` return): the rows at
    the front, the capacity ``capacity`` or the count rounded up to 128."""
    from ssrlcv_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    n = len(feat_dict["loc"])
    fs = FeatureSet.empty(capacity or ((n + 127) // 128) * 128, parent=parent, device=dev)
    for name, key in (("loc", "loc"), ("sigma", "sigma"), ("theta", "theta"),
                      ("descriptors", "values"), ("parent", "parent")):
        dst = getattr(fs, name)
        dst[:n] = torch.as_tensor(feat_dict[key], device=dev).to(dst.dtype)
    fs.mask[:n] = True
    return fs
