"""Reader for the IPOL "Anatomy of SIFT" reference-implementation output.

The port's own copy of ``ssrlcv_tpu/io/anatomy.py`` (numpy only).

Mirror of io_fmt_anatomy (io_fmt_anatomy.cuh:23-30, io_fmt_anatomy.cu):
whitespace-separated text files of keypoints (x y sigma theta + 128 ints) and
matches (x1 y1 s1 t1 x2 y2 s2 t2), used to cross-validate SIFT output against
a published gold standard.
"""

from __future__ import annotations

import io
from typing import TextIO, Union

import numpy as np


def read_features(source: Union[str, TextIO]) -> dict:
    """Parse an Anatomy-of-SIFT keypoint file.

    Returns {'loc' (N,2) f32, 'sigma' (N,), 'theta' (N,), 'values' (N,128) u8}.
    """
    if isinstance(source, str):
        with open(source) as f:
            return read_features(f)
    locs, sigmas, thetas, descs = [], [], [], []
    for line in source:
        parts = line.split()
        if len(parts) < 4 + 128:
            continue
        vals = [float(v) for v in parts]
        locs.append(vals[0:2])
        sigmas.append(vals[2])
        thetas.append(vals[3])
        descs.append([int(v) for v in vals[4 : 4 + 128]])
    return {
        "loc": np.asarray(locs, np.float32).reshape(-1, 2),
        "sigma": np.asarray(sigmas, np.float32),
        "theta": np.asarray(thetas, np.float32),
        "values": np.asarray(descs, np.uint8).reshape(-1, 128),
        "parent": np.full(len(sigmas), -1, np.int32),
    }


def write_features(dest: Union[str, TextIO], loc, sigma, theta, values) -> None:
    """Write keypoints in the Anatomy-of-SIFT text format (one line per
    keypoint: ``x y sigma theta v0 .. v127``) — the inverse of
    ``read_features``, so our SIFT output can be diffed against the IPOL
    CLI's with their own tooling (the cross-validation hook
    io_fmt_anatomy.cuh:23-30 points at)."""
    if isinstance(dest, str):
        with open(dest, "w") as f:
            return write_features(f, loc, sigma, theta, values)
    loc = np.asarray(loc, np.float32)
    values = np.asarray(values, np.uint8)
    for i in range(loc.shape[0]):
        head = f"{loc[i, 0]:.6f} {loc[i, 1]:.6f} {float(sigma[i]):.6f} {float(theta[i]):.6f}"
        dest.write(head + " " + " ".join(str(int(v)) for v in values[i]) + "\n")


def write_matches(dest: Union[str, TextIO], loc0, sigma0, theta0,
                  loc1, sigma1, theta1) -> None:
    """Write matches in the Anatomy-of-SIFT text format
    (``x1 y1 s1 t1 x2 y2 s2 t2`` per line; readMatches io_fmt_anatomy.cu:60)."""
    if isinstance(dest, str):
        with open(dest, "w") as f:
            return write_matches(f, loc0, sigma0, theta0, loc1, sigma1, theta1)
    loc0 = np.asarray(loc0, np.float32)
    loc1 = np.asarray(loc1, np.float32)
    for i in range(loc0.shape[0]):
        dest.write(
            f"{loc0[i, 0]:.6f} {loc0[i, 1]:.6f} {float(sigma0[i]):.6f} {float(theta0[i]):.6f} "
            f"{loc1[i, 0]:.6f} {loc1[i, 1]:.6f} {float(sigma1[i]):.6f} {float(theta1[i]):.6f}\n"
        )


def read_matches(source: Union[str, TextIO]) -> dict:
    """Parse an Anatomy-of-SIFT match file.

    Returns {'loc0' (N,2), 'loc1' (N,2), 'sigma0', 'theta0', 'sigma1',
    'theta1'}.
    """
    if isinstance(source, str):
        with open(source) as f:
            return read_matches(f)
    rows = []
    for line in source:
        parts = line.split()
        if len(parts) < 8:
            continue
        rows.append([float(v) for v in parts[:8]])
    a = np.asarray(rows, np.float32).reshape(-1, 8)
    return {
        "loc0": a[:, 0:2],
        "sigma0": a[:, 2],
        "theta0": a[:, 3],
        "loc1": a[:, 4:6],
        "sigma1": a[:, 6],
        "theta1": a[:, 7],
    }
