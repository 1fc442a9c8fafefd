"""CSV / match-file / binary camera-parameter I/O.

The port's own copy of ``ssrlcv_tpu/io/csvio.py`` (numpy only).

Mirrors the reference's writeCSV family (io_util.hpp:362-408), match file
read/write (writeMatchFile/readMatchFile, MatchFactory.cu:1120-1239), and the
``.bcp`` binary camera spec (bcpFormat, io_util.hpp:422-430).
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Sequence

import numpy as np


def write_csv(values: Iterable, path: str, header: str | None = None) -> str:
    """writeCSV: one value (or comma-joined row) per line."""
    if not path.endswith(".csv"):
        path += ".csv"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        for v in values:
            if isinstance(v, (tuple, list, np.ndarray)):
                f.write(",".join(str(x) for x in v) + "\n")
            else:
                f.write(f"{v}\n")
    return path


def read_csv(path: str) -> list[list[str]]:
    with open(path) as f:
        return [line.strip().split(",") for line in f if line.strip()]


def write_match_file(loc0: np.ndarray, loc1: np.ndarray, path: str, binary: bool = True) -> str:
    """writeMatchFile (MatchFactory.cu:1120): per match the two keypoint
    locations, binary as 4 float32 or text as comma-separated."""
    loc0 = np.asarray(loc0, np.float32)
    loc1 = np.asarray(loc1, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if binary:
        with open(path, "wb") as f:
            inter = np.empty((len(loc0), 4), "<f4")
            inter[:, 0:2] = loc0
            inter[:, 2:4] = loc1
            f.write(inter.tobytes())
    else:
        with open(path, "w") as f:
            for a, b in zip(loc0, loc1):
                f.write(f"{a[0]},{a[1]},{b[0]},{b[1]}\n")
    return path


def read_match_file(path: str, binary: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """readMatchFile: inverse of write_match_file."""
    if binary:
        raw = np.fromfile(path, "<f4").reshape(-1, 4)
    else:
        raw = np.array([[float(v) for v in row] for row in read_csv(path)], np.float32)
    return raw[:, 0:2].copy(), raw[:, 2:4].copy()


BCP_MAGIC = b"BCP1"


def write_bcp(path: str, cameras: Sequence[dict]) -> str:
    """Binary camera parameters (.bcp): one record per camera with the
    params.csv fields (bcpFormat, io_util.hpp:422-430)."""
    with open(path, "wb") as f:
        f.write(BCP_MAGIC)
        f.write(struct.pack("<I", len(cameras)))
        for c in cameras:
            f.write(struct.pack(
                "<3f3f2ff2fq",
                *np.asarray(c["cam_pos"], np.float32),
                *np.asarray(c["cam_rot"], np.float32),
                *np.asarray(c["fov"], np.float32),
                float(c["foc"]),
                *np.asarray(c["dpix"], np.float32),
                int(c.get("timestamp", 0)),
            ))
    return path


def read_bcp(path: str) -> list[dict]:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != BCP_MAGIC:
            raise ValueError(f"not a bcp file: {path}")
        (n,) = struct.unpack("<I", f.read(4))
        out = []
        rec = struct.Struct("<3f3f2ff2fq")
        for _ in range(n):
            vals = rec.unpack(f.read(rec.size))
            out.append({
                "cam_pos": np.asarray(vals[0:3], np.float32),
                "cam_rot": np.asarray(vals[3:6], np.float32),
                "fov": np.asarray(vals[6:8], np.float32),
                "foc": vals[8],
                "dpix": np.asarray(vals[9:11], np.float32),
                "timestamp": vals[11],
            })
        return out
