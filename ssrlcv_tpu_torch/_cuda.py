"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files are compiled by one ``nvcc`` call for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.  The
library lives in ``build/ssrlcv_tpu_torch/`` beside the package and its name
carries a hash of the sources and flags, so a stale library is never loaded.
It is built at first use (nothing happens at import), once per process.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ssrlcv_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (see csrc/*.cu)
_SIGNATURES = {
    "ssrlcv_orient_hist": [_P, _P, _I, _I, _P, _P, _I, _I, _F, _F, _F, _P, _P],
    "ssrlcv_desc_hist": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "ssrlcv_match_keys": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    "ssrlcv_match_best": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P],
    "ssrlcv_match_layout": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P, _P],
    "ssrlcv_match_mma": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P],
    "ssrlcv_extract_patches": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "ssrlcv_patch_row_sums": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build (None: not built here)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libssrlcv_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` unless the hashed library already exists;
    returns its path."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cus = [s for s in _sources() if s.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
