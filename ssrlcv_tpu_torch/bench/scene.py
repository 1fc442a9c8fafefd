"""What the measurement drivers of ``ssrlcv_tpu_torch.bench`` share: the
scene they run on, its truth, the card they ran on and the H100's peaks.

A scene is either the reference's fixture layout (``--fixture DIR``, a
``test/checkpoints/Pipeline{2,3}View`` directory read by
``io.refdata.load_fixture_dir``: images, cameras, seed features and the
golden clouds ``points0`` / ``points1``) or, without one, the seeded
synthetic scene of ``ssrlcv_tpu_torch.synthetic`` (its truth the sphere it
was rendered from).  The seed image's SIFT is computed once, when the scene
is loaded, outside every timed window, as ``bench.py`` reads its fixture's
seed features before timing.

A driver's ``main`` stops with a message (``require_cuda``) when no CUDA
device is present; it does not carry on on the CPU.  Its inner functions
take ``device="cpu"`` for the tests, which read counts and correctness
fields from them, never times.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ssrlcv_tpu_torch.config import SIFTParams

# published peaks of one H100 SXM at 700 W (dense): a function's bound is
# the larger of its bytes (each input read once, each output written once)
# over the memory rate and its operations over the peak rate of their type
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
H100_INT8_PER_S = 1979e12


def require_cuda(prog: str) -> torch.device:
    """``cuda:0``; stops the program with a message when there is no CUDA
    device (a measurement never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: needs a CUDA device; none is available")
    return torch.device("cuda:0")


def device_record() -> dict:
    """The card the run took place on: {"name", "power_limit_w", "count"},
    from ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (its first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    name, limit = (v.strip() for v in out[0].rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]), "count": len(out)}


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Scene:
    images: list                 # [RefImage, ...], ids 0 .. n-1
    cameras: object              # core.types.Cameras on the device
    seed: object                 # FeatureSet of the seed image on the device
    record: dict                 # what the driver's JSON record names as "scene"
    fixture: Optional[dict] = None      # load_fixture_dir's dict, with a fixture
    synthetic: Optional[object] = None  # synthetic.SyntheticScene, without one

    @property
    def truth(self) -> str:
        """The truth distances are taken to: "golden" (the fixture's golden
        cloud) or "surface" (the synthetic scene's sphere)."""
        return "golden" if self.fixture is not None else "surface"

    def distance_m(self, points, golden: str = "points0") -> np.ndarray:
        """Metres from each point (n, 3) km to the truth: with a fixture, to
        the nearest point of its golden cloud ``golden`` (``bench.py``'s
        cKDTree query); else to the synthetic scene's true surface."""
        pts = points.cpu().numpy() if isinstance(points, torch.Tensor) else np.asarray(points)
        if self.fixture is None:
            return self.synthetic.surface_distance_m(pts)
        from scipy.spatial import cKDTree

        return cKDTree(self.fixture[golden]).query(pts)[0] * 1000.0


def load(fixture: Optional[str] = None, size: int = 1024, seed: int = 0, n_views: int = 2,
         device=None, synthetic=None) -> Scene:
    """The scene of ``n_views`` images on ``device`` (None: ``cuda:0``):
    the fixture directory ``fixture``, or else ``synthetic.make_scene(seed,
    size, n_views)``; ``synthetic`` is such a scene already made in this
    process (of at least ``n_views`` views at ``size``, from ``seed``), used
    in its place.  The seed features: with a fixture its feature dump
    (``features_from_refdata``), else SIFT of the seed image."""
    from ssrlcv_tpu_torch.core.device import resolve_device
    from ssrlcv_tpu_torch.features.sift import features_from_refdata, generate_features
    from ssrlcv_tpu_torch.io.images import cameras_from_refimages

    dev = resolve_device(device)
    if fixture is not None:
        from ssrlcv_tpu_torch.io import refdata

        fx = refdata.load_fixture_dir(fixture, n_views)
        return Scene(images=fx["images"], cameras=cameras_from_refimages(fx["images"], dev),
                     seed=features_from_refdata(fx["seed_features"], device=dev),
                     record={"kind": "fixture", "path": fixture, "views": n_views},
                     fixture=fx)
    if synthetic is None:
        from ssrlcv_tpu_torch.synthetic import make_scene

        synthetic = make_scene(seed, size, n_views=n_views)
    if len(synthetic.images) < n_views or synthetic.images[0].pixels.shape[0] != size:
        raise ValueError(f"the scene given has {len(synthetic.images)} views at "
                         f"{synthetic.images[0].pixels.shape[0]}^2, not {n_views} at {size}^2")
    synthetic = dataclasses.replace(synthetic, images=synthetic.images[:n_views])
    seed_fs = generate_features(synthetic.seed_image.pixels, SIFTParams(), image_id=-1,
                                device=dev)
    sync(dev)
    return Scene(images=synthetic.images, cameras=cameras_from_refimages(synthetic.images, dev),
                 seed=seed_fs, record={"kind": "synthetic", "seed": seed, "size": size,
                                       "views": n_views},
                 synthetic=synthetic)


def min_seconds(fn, device, reps: int = 3):
    """(result of the last call, the least host seconds of ``reps`` calls of
    ``fn`` after one warm-up), each call timed to a synchronisation of
    ``device``: the card's time for the work, launches included."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return out, best
