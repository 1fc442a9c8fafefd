"""Image and camera-parameter loading.

Counterpart of ``ssrlcv_tpu/io/images.py``: read an image, find the sibling
``params.csv`` and take the row whose first field is the image's file name,
then offset every camera position by image 0's (ECEF offset), so the
reconstruction is centred near the origin.  Parsing and the float32
subtraction are the JAX package's, so both packages load identical cameras.

8-bit grayscale and RGB PNG files (non-interlaced) are read and written here
with ``zlib`` and numpy, so the port needs no imaging library for them.
Other files go through PIL, which must then be installed.
"""

from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np

from ssrlcv_tpu_torch.io.refdata import RefImage
from ssrlcv_tpu_torch.logging import logger
from ssrlcv_tpu_torch.core.device import resolve_device
from ssrlcv_tpu_torch.core.types import Cameras, PushbroomCameras

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3}  # colour type -> channels (grayscale, RGB)


def _png_chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth_row(cur: bytearray, prev: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = cur
        elif kind == 1:    # Sub: a running sum per channel, modulo 256
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint64).astype(
                np.uint8).reshape(-1)
        elif kind == 2:    # Up
            out[y] = cur + prev
        elif kind in (3, 4):
            row = bytearray(cur.tobytes())
            (_average_row if kind == 3 else _paeth_row)(row, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        prev = out[y]
    return out


def _read_png(path: str) -> Optional[np.ndarray]:
    """Decode an 8-bit grayscale or RGB non-interlaced PNG; None for any
    other PNG form."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        return None
    ch = _PNG_CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return px.reshape(h, w, ch)[..., 0] if ch == 1 else px.reshape(h, w, ch)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pil_image():
    try:
        from PIL import Image as PILImage
    except ImportError:
        return None
    return PILImage


def read_image(path: str) -> np.ndarray:
    """Read an image file as (H, W) or (H, W, C) uint8."""
    if path.lower().endswith(".png"):
        px = _read_png(path)
        if px is not None:
            return px
    pil = _pil_image()
    if pil is None:
        raise ImportError(f"{path}: only 8-bit grayscale or RGB non-interlaced PNG is read "
                          "without PIL; install Pillow to read this file")
    with pil.open(path) as im:
        return np.asarray(im)


def write_image(path: str, pixels: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint8 pixels; PNG without PIL (filter
    type None on every row), any other extension through PIL."""
    px = np.ascontiguousarray(pixels)
    if path.lower().endswith(".png"):
        if px.dtype != np.uint8 or not (px.ndim == 2 or (px.ndim == 3 and px.shape[2] == 3)):
            raise ValueError(f"{path}: PNG writing takes (H, W) or (H, W, 3) uint8, got "
                             f"{px.shape} {px.dtype}")
        h, w = px.shape[:2]
        rows = px.reshape(h, -1)
        raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
        colour = 0 if px.ndim == 2 else 2
        data = (_PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return
    pil = _pil_image()
    if pil is None:
        raise ImportError(f"{path}: only PNG is written without PIL; install Pillow")
    pil.fromarray(px).save(path)


def to_grayscale(pixels: np.ndarray) -> np.ndarray:
    """Average-channel conversion to grayscale (rounded half up)."""
    if pixels.ndim == 2:
        return pixels
    return (pixels.astype(np.float32).mean(axis=-1) + 0.5).astype(np.uint8)


def _camera_row_to_dict(row: Sequence[str]) -> dict:
    """One pinhole params.csv row:
    filename,x,y,z,rx,ry,rz,fov_x,fov_y,foc,dpix_x,dpix_y,timestamp,size_x[,size_y]"""
    vals = [v.strip() for v in row]
    return {
        "filename": vals[0],
        "cam_pos": np.array([float(vals[1]), float(vals[2]), float(vals[3])], np.float32),
        "cam_rot": np.array([float(vals[4]), float(vals[5]), float(vals[6])], np.float32),
        "fov": np.array([float(vals[7]), float(vals[8])], np.float32),
        "foc": float(vals[9]),
        "dpix": np.array([float(vals[10]), float(vals[11])], np.float32),
        "timestamp": int(float(vals[12])) if len(vals) > 12 else 0,
    }


def _pushbroom_row_to_dict(vals: list, size: Optional[tuple] = None) -> dict:
    """One pushbroom params.csv row:
    ``filename,pushbroom,lat,lon,axis_radius,roll,altitude,foc,gsd_m,fov_deg``.
    gsd m -> km, fov deg -> rad, dpix.x = foc*tan(fov/2)/(size.x/2) and
    dpix.y = 0 (the reference leaves it at its zero default)."""
    pb = {
        "projection_center": np.array([float(vals[2]), float(vals[3])], np.float32),
        "axis_radius": float(vals[4]),
        "roll": float(vals[5]),
        "altitude": float(vals[6]),
        "foc": float(vals[7]),
        "gsd": float(vals[8]) / 1000.0,
        "fov": float(vals[9]) * (np.pi / 180.0),
    }
    if size is not None:
        pb["dpix"] = np.array([pb["foc"] * np.tan(pb["fov"] / 2.0) / (size[0] / 2.0), 0.0],
                              np.float32)
    else:
        pb["dpix"] = np.zeros(2, np.float32)
    return {"filename": vals[0], "pushbroom": pb}


def load_params_csv(path: str, size: Optional[tuple] = None) -> dict:
    """params.csv as {filename: camera dict}; a pushbroom row (second field
    'pushbroom') parses into a nested 'pushbroom' dict.  A row that does not
    parse is logged as an error and skipped."""
    out = {}
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            try:
                if len(row) > 1 and row[1].strip().lower() == "pushbroom":
                    d = _pushbroom_row_to_dict([v.strip() for v in row], size)
                else:
                    d = _camera_row_to_dict(row)
            except (ValueError, IndexError) as e:
                logger.err(f"params.csv: cannot parse row {row[:2]}...: {e} — the "
                           "image will have NO camera parameters")
                continue
            out[d["filename"]] = d
    return out


def load_image_with_params(path: str, image_id: int, no_params: bool = False) -> RefImage:
    """One image and its params.csv camera row as a RefImage."""
    pixels = to_grayscale(read_image(path))
    h, w = pixels.shape
    img = RefImage(
        id=image_id, size=(w, h), color_depth=1,
        cam_pos=np.zeros(3, np.float32), cam_rot=np.zeros(3, np.float32),
        fov=np.zeros(2, np.float32), foc=0.0, dpix=np.zeros(2, np.float32), timestamp=0,
        ecef_offset=np.zeros(3, np.float32), is_pushbroom=False, pixels=pixels)
    if no_params:
        return img
    params_path = os.path.join(os.path.dirname(path), "params.csv")
    if not os.path.exists(params_path):
        return img
    key = os.path.basename(path)
    params = load_params_csv(params_path, size=(w, h))
    if key not in params:
        logger.warn(f"{key}: no row in {params_path} — camera parameters "
                    "stay zero (matching/triangulation will degenerate)")
        return img
    p = params[key]
    if "pushbroom" in p:
        img.is_pushbroom = True
        img.pushbroom = p["pushbroom"]
    else:
        img.cam_pos, img.cam_rot, img.fov = p["cam_pos"], p["cam_rot"], p["fov"]
        img.foc, img.dpix, img.timestamp = p["foc"], p["dpix"], p["timestamp"]
    return img


def load_directory(dirpath: str, no_params: bool = False) -> list:
    """Every image of a directory, sorted by name, with camera positions
    offset by image 0's position (the ECEF offset), in float32."""
    paths = sorted(os.path.join(dirpath, f) for f in os.listdir(dirpath)
                   if f.lower().endswith(IMAGE_EXTENSIONS))
    images = [load_image_with_params(p, i, no_params) for i, p in enumerate(paths)]
    if images and not no_params:
        offset = images[0].cam_pos.copy()
        for im in images:
            im.ecef_offset = offset
            im.cam_pos = im.cam_pos - offset
    return images


def cameras_from_refimages(images: Iterable[RefImage], device=None) -> Cameras:
    """Stack host RefImages into batched Cameras on ``device`` (None:
    ``cuda:0``, which raises without a card)."""
    ims = list(images)
    return Cameras.from_numpy(
        device=resolve_device(device),
        cam_pos=np.stack([im.cam_pos for im in ims]).astype(np.float32),
        cam_rot=np.stack([im.cam_rot for im in ims]).astype(np.float32),
        fov=np.stack([im.fov for im in ims]).astype(np.float32),
        foc=np.array([im.foc for im in ims], np.float32),
        dpix=np.stack([im.dpix for im in ims]).astype(np.float32),
        size=np.array([[im.size[0], im.size[1]] for im in ims], np.int32),
        ecef_offset=np.stack([im.ecef_offset for im in ims]).astype(np.float32),
        timestamp=np.array([im.timestamp for im in ims], np.int64),
    )


def pushbrooms_from_refimages(images: Iterable[RefImage],
                              device=None) -> Optional[PushbroomCameras]:
    """Stack pushbroom RefImages into batched PushbroomCameras on ``device``
    (None: ``cuda:0``).  None unless image 0 is pushbroom: the dispatch is on
    image 0 alone, so a set whose later images alone are pushbroom runs the
    pinhole path."""
    ims = list(images)
    if not ims or not ims[0].is_pushbroom:
        return None
    n = len(ims)

    def get(key, shape=()):
        return np.array([np.asarray(im.pushbroom[key], np.float32) for im in ims],
                        np.float32).reshape((n,) + shape)

    return PushbroomCameras.from_numpy(
        device=resolve_device(device),
        start_pos=np.zeros((n, 3), np.float32), end_pos=np.zeros((n, 3), np.float32),
        projection_center=get("projection_center", (2,)), axis_radius=get("axis_radius"),
        roll=get("roll"), altitude=get("altitude"), foc=get("foc"), fov=get("fov"),
        gsd=get("gsd"), dpix=get("dpix", (2,)),
        size=np.array([[im.size[0], im.size[1]] for im in ims], np.int32))
