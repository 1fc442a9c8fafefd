"""Stage-door checkpoint / resume.

Counterpart of ``ssrlcv_tpu/io/checkpoint.py``, with the same layout: a
stage's state goes to ``<root>/sfm-stage<N>/<name>.npz`` with a
``meta.json`` and an empty ``done`` marker, and a run resumes at the first
stage whose marker is missing.  Files are written to a temporary name and
renamed into place, so an interrupted write never leaves a marker over a
torn archive.

A state is a dict of the port's dataclasses of tensors; each array is stored
under ``<entry>.<field>`` (e.g. ``matches.kp_loc``).  The JAX package stores
flattened pytree leaves instead, so the two packages do not read each
other's checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch


def stage_dir(root: str, stage_index: int) -> str:
    return os.path.join(root, f"sfm-stage{stage_index}")


def is_stage_done(root: str, stage_index: int) -> bool:
    return os.path.exists(os.path.join(stage_dir(root, stage_index), "done"))


def first_unfinished_stage(root: str, num_stages: int) -> int:
    """Index of the first stage without a done marker."""
    for i in range(num_stages):
        if not is_stage_done(root, i):
            return i
    return num_stages


def _atomic_write(path: str, write) -> None:
    """Write through ``write(file)`` to a temporary file, then rename it
    over ``path``."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_state(path: str, state: dict) -> None:
    """Write {entry: dataclass of tensors} to one NPZ archive."""
    arrays = {f"{name}.{f.name}": getattr(value, f.name).detach().cpu().numpy()
              for name, value in state.items() for f in dataclasses.fields(value)}
    _atomic_write(path, lambda f: np.savez(f, **arrays))


def load_state(path: str, like: dict, device=None) -> dict:
    """Read an NPZ archive into the entries and shapes of ``like`` on
    ``device``; a missing array or another shape raises ValueError."""
    out = {}
    with np.load(path) as z:
        for name, value in like.items():
            fields = {}
            for f in dataclasses.fields(value):
                key = f"{name}.{f.name}"
                want = tuple(getattr(value, f.name).shape)
                if key not in z.files:
                    raise ValueError(f"checkpoint {path} has no array {key}")
                got = z[key]
                if tuple(got.shape) != want:
                    raise ValueError(f"checkpoint array {key} has shape {got.shape}, "
                                     f"expected {want} in {path}")
                fields[f.name] = torch.as_tensor(got, device=device)
            out[name] = type(value)(**fields)
    return out


def save_stage(root: str, stage_index: int, name: str, state: dict,
               meta: Optional[dict] = None) -> None:
    """Write a stage's state, its meta.json and then its done marker."""
    d = stage_dir(root, stage_index)
    save_state(os.path.join(d, f"{name}.npz"), state)
    if meta is not None:
        _atomic_write(os.path.join(d, "meta.json"), lambda f: f.write(json.dumps(meta).encode()))
    with open(os.path.join(d, "done"), "w"):
        pass


def load_stage(root: str, stage_index: int, name: str, like: dict, device=None) -> dict:
    return load_state(os.path.join(stage_dir(root, stage_index), f"{name}.npz"), like, device)


def load_stage_meta(root: str, stage_index: int) -> Optional[dict]:
    p = os.path.join(stage_dir(root, stage_index), "meta.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None
