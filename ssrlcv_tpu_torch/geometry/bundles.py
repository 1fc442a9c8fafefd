"""Ray (bundle) generation from match tracks (pinhole cameras).

Counterpart of the pinhole branch of ``ssrlcv_tpu/geometry/bundles.py``:
every (track, view) slot is lifted to a world ray, with camera parameters
gathered per slot through the parent-id tensor.
"""

from __future__ import annotations

import torch

from ssrlcv_tpu_torch.core import camera_math
from ssrlcv_tpu_torch.core.types import Bundles, Cameras, MatchSet


def generate_bundles(matches: MatchSet, cameras: Cameras) -> Bundles:
    """Lift each track's keypoints to world-frame rays: pixel -> image-plane
    point at z=foc (dpix from fov/foc, square pixels), rotated by cam_rot,
    origin cam_pos."""
    parent = torch.clamp(matches.kp_parent, min=0).to(torch.int64)
    vec, pnt = camera_math.pixel_to_ray(
        matches.kp_loc, cameras.cam_pos[parent], cameras.cam_rot[parent],
        cameras.foc[parent], cameras.fov[:, 0][parent], cameras.size[parent])
    return Bundles(vec=vec, pnt=pnt, num_views=matches.num_views, mask=matches.mask)
