"""PLY point-cloud / mesh I/O.

The port's own copy of ``ssrlcv_tpu/io/ply.py`` (the reference's vendored
tinyply + writePLY, io_util.hpp:240-354), with numpy alone: ascii and
binary little-endian files of points with optional uchar colours and
normals and triangle / quad faces, the wireframe (vertex + edge) writer and
the gradient-coloured writer of the debug clouds.  For the same arrays the
files equal the JAX package's byte for byte but for the comment line.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
          "char": "i1", "int": "<i4", "int32": "<i4", "uint": "<u4", "short": "<i2",
          "ushort": "<u2"}


def _prepare(path: str) -> str:
    if not path.endswith(".ply"):
        path += ".ply"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None, faces: Optional[np.ndarray] = None,
              binary: bool = True, comment: str = "generated by ssrlcv_tpu_torch") -> str:
    """Write a PLY file (``.ply`` appended when missing); returns the path.
    points (N, 3) float; colors (N, 3) uint8; normals (N, 3) float; faces
    (F, 3 or 4) int."""
    points = np.asarray(points, "<f4").reshape(-1, 3)
    n = len(points)
    path = _prepare(path)
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"comment {comment}", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            dt = [("xyz", "<f4", 3)]
            if normals is not None:
                dt.append(("n", "<f4", 3))
            if colors is not None:
                dt.append(("rgb", "u1", 3))
            rec = np.empty(n, np.dtype(dt))
            rec["xyz"] = points
            if normals is not None:
                rec["n"] = normals
            if colors is not None:
                rec["rgb"] = np.asarray(colors, np.uint8)
            f.write(rec.tobytes())
            if faces is not None:
                faces = np.asarray(faces, "<i4")
                k = faces.shape[1]
                frec = np.empty(len(faces), np.dtype([("cnt", "u1"), ("idx", "<i4", k)]))
                frec["cnt"] = k
                frec["idx"] = faces
                f.write(frec.tobytes())
        else:
            rows = []
            for i in range(n):
                row = list(points[i]) + (list(normals[i]) if normals is not None else [])
                line = " ".join(f"{v:.6f}" for v in row)
                if colors is not None:
                    line += " " + " ".join(str(int(v)) for v in colors[i])
                rows.append(line + "\n")
            if faces is not None:
                rows += [f"{len(face)} " + " ".join(map(str, face)) + "\n" for face in faces]
            f.write("".join(rows).encode())
    return path


def write_ply_edges(path: str, vertices: np.ndarray, edges: np.ndarray,
                    points: Optional[np.ndarray] = None, binary: bool = True) -> str:
    """Write a wireframe PLY: vertex + edge elements, optionally with a point
    cloud prepended to the vertex list (its edges offset past it)."""
    vertices = np.asarray(vertices, np.float32)
    edges = np.asarray(edges, np.int64)
    if points is not None:
        points = np.asarray(points, np.float32)
        edges = edges + len(points)
        vertices = np.concatenate([points, vertices], axis=0)
    path = _prepare(path)
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {len(vertices)}",
              "property float x", "property float y", "property float z",
              f"element edge {len(edges)}", "property int vertex1", "property int vertex2",
              "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(vertices.astype("<f4").tobytes())
            f.write(edges.astype("<i4").tobytes())
        else:
            f.write("".join(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in vertices).encode())
            f.write("".join(f"{int(e[0])} {int(e[1])}\n" for e in edges).encode())
    return path


def write_ply_gradient(path: str, points: np.ndarray, values: np.ndarray,
                       binary: bool = True) -> str:
    """Points coloured by value, blue -> green -> red over the value range."""
    v = np.asarray(values, np.float32)
    lo, hi = float(v.min()), float(v.max())
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    r = np.clip(2 * t - 1, 0, 1)
    g = 1 - np.abs(2 * t - 1)
    b = np.clip(1 - 2 * t, 0, 1)
    colors = (np.stack([r, g, b], 1) * 255).astype(np.uint8)
    return write_ply(path, points, colors=colors, binary=binary)


def read_ply(path: str) -> dict:
    """Read a PLY file (ascii or binary little-endian) into {'points' (N, 3)
    float32, 'colors' (N, 3) uint8 or None, 'normals' (N, 3) float32 or
    None, 'faces' (F, k) int32 or None}."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    fmt, elements = "ascii", []
    for line in data[:end].decode().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], None))
            else:
                elements[-1][2].append((parts[2], _TYPES[parts[1]]))

    out = {"points": None, "colors": None, "normals": None, "faces": None}
    lines = iter(data[end:].decode().splitlines()) if fmt == "ascii" else None
    offset = end
    for name, count, props in elements:
        if name == "vertex":
            dt = np.dtype(props)
            if fmt == "ascii":
                rows = [next(lines).split() for _ in range(count)]
                arr = np.zeros(count, dt)
                for j, (pn, _) in enumerate(props):
                    arr[pn] = [float(r[j]) for r in rows]
            else:
                arr = np.frombuffer(data, dt, count=count, offset=offset)
                offset += dt.itemsize * count
            out["points"] = np.stack([arr["x"], arr["y"], arr["z"]], 1).astype(np.float32)
            if all(c in dt.names for c in ("red", "green", "blue")):
                out["colors"] = np.stack([arr["red"], arr["green"], arr["blue"]], 1)
            if all(c in dt.names for c in ("nx", "ny", "nz")):
                out["normals"] = np.stack([arr["nx"], arr["ny"], arr["nz"]], 1).astype(np.float32)
        elif name == "face":
            faces = []
            for _ in range(count):
                if fmt == "ascii":
                    parts = next(lines).split()
                    faces.append([int(x) for x in parts[1:1 + int(parts[0])]])
                else:
                    k = data[offset]
                    faces.append(np.frombuffer(data, "<i4", count=k, offset=offset + 1))
                    offset += 1 + 4 * k
            if faces:
                out["faces"] = np.array(faces, np.int32)
    return out
