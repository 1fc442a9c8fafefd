"""Readers for the reference framework's binary fixture formats.

The port's own copy of ``ssrlcv_tpu/io/refdata.py`` (``RefImage`` and the
fixture-directory loader).  The reference (uga-ssrl/SSRLCV) checkpoints
arrays as ``.uty`` files (Unity<T>::checkpoint, Unity.cuh:924-971) and
camera metadata as raw-struct ``.cpimg`` dumps (Image::checkpoint,
Image.cu:274-303); its test suite ships golden per-stage checkpoints under
test/checkpoints/Pipeline{2,3}View.

``.uty`` layout (little-endian):
    <typeid name>\\n  <u64 hash>\\n  <i32 MemoryState> <u64 numElements>\\n
    <raw element bytes>

Element layouts (x86-64 / CUDA alignment rules):
    float3                      : 3*f32 (12 B)
    KeyPoint                    : i32 parentId, pad4, 2*f32 loc      (16 B)
    MultiMatch                  : u32 numKeyPoints, i32 index        (8 B)
    Feature<SIFT_Descriptor>    : i32 parent, pad4, 2*f32 loc,
                                  f32 sigma, f32 theta, u8[128]      (152 B)
    unsigned char ('h')         : u8
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np


def read_uty(path: str, dtype: np.dtype) -> np.ndarray:
    """Read a .uty checkpoint as a structured/plain numpy array."""
    with open(path, "rb") as f:
        data = f.read()
    off = data.index(b"\n") + 1 + 8          # type name, u64 hash
    if data[off:off + 1] != b"\n":
        raise ValueError(f"{path}: not a .uty file")
    (count,) = struct.unpack_from("<Q", data, off + 1 + 4)  # after the i32 memory state
    off += 1 + 4 + 8
    if data[off:off + 1] != b"\n":
        raise ValueError(f"{path}: not a .uty file")
    return np.frombuffer(data, dtype=dtype, count=count, offset=off + 1)


FLOAT3_DT = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
KEYPOINT_DT = np.dtype({"names": ["parentId", "loc"], "formats": ["<i4", "<2f4"],
                        "offsets": [0, 8], "itemsize": 16})
MULTIMATCH_DT = np.dtype([("numKeyPoints", "<u4"), ("index", "<i4")])
FEATURE_SIFT_DT = np.dtype({
    "names": ["parent", "loc", "sigma", "theta", "values"],
    "formats": ["<i4", "<2f4", "<f4", "<f4", "(128,)u1"],
    "offsets": [0, 8, 16, 20, 24],
    "itemsize": 152,
})


def read_float3(path: str) -> np.ndarray:
    """Read a float3 .uty as (N, 3) float32."""
    a = read_uty(path, FLOAT3_DT)
    return np.stack([a["x"], a["y"], a["z"]], axis=1)


def read_keypoints(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a KeyPoint .uty: returns (parent_ids (N,), locs (N,2))."""
    a = read_uty(path, KEYPOINT_DT)
    return a["parentId"].copy(), a["loc"].copy()


def read_multimatches(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a MultiMatch .uty: returns (numKeyPoints (N,), index (N,))."""
    a = read_uty(path, MULTIMATCH_DT)
    return a["numKeyPoints"].astype(np.int64), a["index"].astype(np.int64)


def read_sift_features(path: str) -> dict:
    """Read a Feature<SIFT_Descriptor> .uty."""
    a = read_uty(path, FEATURE_SIFT_DT)
    return {name: a[name].copy() for name in ("parent", "loc", "sigma", "theta", "values")}


@dataclasses.dataclass
class RefImage:
    """Decoded reference Image .cpimg (fields at the offsets written by
    Image::checkpoint's raw-struct dump, Image.cu:274-303), or an image with
    its params.csv camera row."""

    id: int
    size: tuple[int, int]           # (width, height)
    color_depth: int
    cam_pos: np.ndarray             # (3,) km
    cam_rot: np.ndarray             # (3,) rad
    fov: np.ndarray                 # (2,) rad
    foc: float
    dpix: np.ndarray                # (2,)
    timestamp: int
    ecef_offset: np.ndarray         # (3,) km
    is_pushbroom: bool
    pixels: Optional[np.ndarray] = None  # (H, W) uint8
    # pushbroom camera fields parsed from a params.csv pushbroom row
    # (Image.cu:108-141): projection_center (2,), axis_radius, roll,
    # altitude, foc, fov, gsd, dpix (2,)
    pushbroom: Optional[dict] = None


def read_cpimg(path: str, pixels_dir: Optional[str] = None) -> RefImage:
    """Read a .cpimg camera dump, and its ``<id>_h.uty`` pixels from
    ``pixels_dir`` when given."""
    with open(path, "rb") as f:
        raw = f.read()

    def get(fmt, off, n=1):
        v = struct.unpack_from(f"<{n}{fmt}", raw, off)
        return v[0] if n == 1 else np.array(v, np.float32)

    img = RefImage(id=get("i", 32), size=(get("I", 40), get("I", 44)),
                   color_depth=get("I", 48), cam_pos=get("f", 56, 3), cam_rot=get("f", 68, 3),
                   fov=get("f", 80, 2), foc=get("f", 88), dpix=get("f", 96, 2),
                   timestamp=get("q", 104), ecef_offset=get("f", 112, 3),
                   is_pushbroom=bool(raw[208]))
    if pixels_dir is not None:
        w, h = img.size
        img.pixels = read_uty(f"{pixels_dir}/{img.id}_h.uty", np.uint8).reshape(h, w)
    return img


def load_fixture_dir(dirpath: str, num_images: int = 2) -> dict:
    """Load a full Pipeline{2,3}View fixture directory."""
    out: dict = {"images": [read_cpimg(f"{dirpath}/{i}_N6ssrlcv5ImageE.cpimg",
                                       pixels_dir=f"{dirpath}/pixels")
                            for i in range(num_images)]}
    out["seed_features"] = read_sift_features(
        f"{dirpath}/-1_N6ssrlcv7FeatureINS_15SIFT_DescriptorEEE.uty")
    for i in (0, 1):
        out[f"keypoints{i}"] = read_keypoints(f"{dirpath}/{i}_N6ssrlcv8KeyPointE.uty")
        out[f"multimatches{i}"] = read_multimatches(f"{dirpath}/{i}_N6ssrlcv10MultiMatchE.uty")
    for i in (0, 1, 2):
        try:
            out[f"points{i}"] = read_float3(f"{dirpath}/{i}_6float3.uty")
        except FileNotFoundError:
            pass
    return out
