"""Core data model: dataclasses of tensors.

Field names and layouts equal the JAX pytrees of ``ssrlcv_tpu.core.types``
(struct-of-arrays, fixed capacity, validity mask), so a JAX value fetched with
``np.asarray`` becomes the port's with the same values through
``from_numpy(**arrays)``, and ``to_numpy()`` goes the other way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class _TensorStruct:
    """Shared numpy bridge of the dataclasses below."""

    @classmethod
    def from_numpy(cls, device=None, **arrays):
        """Build from numpy arrays (or anything ``np.asarray`` takes), one
        keyword per field, on ``device`` (CPU when None)."""
        names = {f.name for f in dataclasses.fields(cls)}
        if set(arrays) != names:
            raise ValueError(f"{cls.__name__}.from_numpy needs fields {sorted(names)}, "
                             f"got {sorted(arrays)}")
        # np.array copies: a fetched JAX array is read-only, and the port
        # writes into some of these tensors in place
        return cls(**{k: torch.as_tensor(np.array(v), device=device)
                      for k, v in arrays.items()})

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Cameras(_TensorStruct):
    """Batched pinhole cameras; leading axis = image.  Positions in km (ECEF
    minus ``ecef_offset`` of image 0)."""

    cam_pos: torch.Tensor      # (N, 3) float32, km
    cam_rot: torch.Tensor      # (N, 3) float32, XYZ Euler radians
    fov: torch.Tensor          # (N, 2) float32, radians
    foc: torch.Tensor          # (N,) float32
    dpix: torch.Tensor         # (N, 2) float32
    size: torch.Tensor         # (N, 2) int32 (width, height)
    ecef_offset: torch.Tensor  # (N, 3) float32, km
    timestamp: torch.Tensor    # (N,) int64

    @property
    def num_cameras(self) -> int:
        return self.cam_pos.shape[0]


@dataclasses.dataclass
class FeatureSet(_TensorStruct):
    """Fixed-capacity SIFT features for one image."""

    loc: torch.Tensor          # (K, 2) float32 (x, y) pixel location
    sigma: torch.Tensor        # (K,) float32
    theta: torch.Tensor        # (K,) float32
    descriptors: torch.Tensor  # (K, 128) uint8
    mask: torch.Tensor         # (K,) bool
    parent: torch.Tensor       # (K,) int32 parent image id

    @property
    def capacity(self) -> int:
        return self.loc.shape[0]

    def count(self) -> int:
        return int(self.mask.sum())

    @classmethod
    def empty(cls, capacity: int, parent: int = -1, device=None) -> "FeatureSet":
        return cls(
            loc=torch.full((capacity, 2), -1.0, dtype=torch.float32, device=device),
            sigma=torch.zeros((capacity,), dtype=torch.float32, device=device),
            theta=torch.zeros((capacity,), dtype=torch.float32, device=device),
            descriptors=torch.zeros((capacity, 128), dtype=torch.uint8, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
            parent=torch.full((capacity,), parent, dtype=torch.int32, device=device),
        )


@dataclasses.dataclass
class MatchSet(_TensorStruct):
    """Match tracks in padded (T, V) layout."""

    kp_loc: torch.Tensor     # (T, V, 2) float32
    kp_parent: torch.Tensor  # (T, V) int32, -1 = empty slot
    num_views: torch.Tensor  # (T,) int32
    mask: torch.Tensor       # (T,) bool

    @property
    def capacity(self) -> int:
        return self.kp_loc.shape[0]

    def count(self) -> int:
        return int(self.mask.sum())


@dataclasses.dataclass
class Bundles(_TensorStruct):
    """Rays lifted from match tracks, padded (T, V) layout."""

    vec: torch.Tensor        # (T, V, 3) float32 unit direction
    pnt: torch.Tensor        # (T, V, 3) float32 camera origin
    num_views: torch.Tensor  # (T,) int32
    mask: torch.Tensor       # (T,) bool

    @property
    def capacity(self) -> int:
        return self.vec.shape[0]


@dataclasses.dataclass
class PointCloud(_TensorStruct):
    """Triangulated points and per-point errors."""

    points: torch.Tensor  # (T, 3) float32
    errors: torch.Tensor  # (T,) float32
    mask: torch.Tensor    # (T,) bool

    def compact(self) -> np.ndarray:
        """The valid points as a dense (n, 3) numpy array."""
        return self.points[self.mask].detach().cpu().numpy()
