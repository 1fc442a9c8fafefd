"""PLY point-cloud I/O.

The port's own copy of the point-cloud part of ``ssrlcv_tpu/io/ply.py``
(the reference's vendored tinyply + writePLY, io_util.hpp:240-354), with
numpy alone: ``write_ply`` writes points as binary little-endian or ascii,
``read_ply`` reads the vertex element of either form.
"""

from __future__ import annotations

import io
import os

import numpy as np

_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
          "char": "i1", "int": "<i4", "int32": "<i4", "uint": "<u4", "short": "<i2",
          "ushort": "<u2"}


def write_ply(path: str, points: np.ndarray, binary: bool = True,
              comment: str = "generated by ssrlcv_tpu_torch") -> str:
    """Write (N, 3) points as a PLY file (``.ply`` appended when missing);
    returns the path."""
    points = np.asarray(points, "<f4").reshape(-1, 3)
    if not path.endswith(".ply"):
        path += ".ply"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"comment {comment}", f"element vertex {len(points)}",
              "property float x", "property float y", "property float z", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(points.tobytes())
        else:
            f.write("".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in points).encode())
    return path


def read_ply(path: str) -> dict:
    """Read the vertex element (the first element) of a PLY file, ascii or
    binary little-endian, into {'points': (N, 3) float32}."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = [line.split() for line in data[:end].decode().splitlines()]
    fmt = next(h[1] for h in header if h[0] == "format")
    elements = [i for i, h in enumerate(header) if h[0] == "element"] + [len(header)]
    if not elements[:-1] or header[elements[0]][1] != "vertex":
        raise ValueError(f"{path}: the first element is not 'vertex'")
    n = int(header[elements[0]][2])
    dt = np.dtype([(h[2], _TYPES[h[1]]) for h in header[elements[0] + 1:elements[1]]
                   if h[0] == "property"])
    if n == 0:
        arr = np.zeros(0, dt)
    elif fmt == "ascii":
        arr = np.loadtxt(io.StringIO(data[end:].decode()), dtype=dt, max_rows=n, ndmin=1)
    else:
        arr = np.frombuffer(data, dt, count=n, offset=end)
    return {"points": np.stack([arr["x"], arr["y"], arr["z"]], 1).astype(np.float32)}
