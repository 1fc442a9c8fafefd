"""ssrlcv_tpu_torch — the structure-from-motion pipeline in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside ``ssrlcv_tpu`` (the JAX reference).  It mirrors the
JAX package's subpackage layout and function names, so each module's
counterpart is easy to find:

    core/        Cameras, FeatureSet, MatchSet, Bundles, PointCloud; camera math
    ops/         image primitives (blur, bin, upsample, gradients)
    features/    scale space, DoG detection, orientation (kernel K1),
                 descriptors (kernel K2), per-keypoint gradient patches
                 (kernel K5, the use_patches route), SIFT orchestration
    matching/    exact descriptor distances, epipolar-gated best target
                 (kernel K3; kernel K4 on the tensor cores), brute-force,
                 F-matrix and double-constrained matching, match-set assembly
    bench/       device timing, the patch-gather micro-benchmark (kernel K6) and
                 the measurement drivers (bench.py's and scripts/' counterparts)
    geometry/    bundles, 2-view triangulation, filters
    ba/          2-view bundle adjustment (Levenberg-Marquardt, torch.func)
    pipeline/    the 2-view reconstruction stages

    config.py    the pipeline's parameters; logging.py the CSV logger;
    tester.py    the reference's Tester executable (logger + match -> triangulate)

It imports ``torch`` and never ``jax``, nor any module of the JAX package:
its configuration, logger, fixture reader and PLY writer are its own copies.
Its entry points run on ``cuda:0`` unless the caller names another device
(``device="cpu"``); without a card they raise.

Precision: float32 convolutions and matrix products are pinned to full
float32 here, at import, because DoG extrema and the Newton refinement are
decided by float32 comparisons, and the exact-integer descriptor distances
rely on float32 products of centred int8 values being exact (TF32 keeps
about three decimal digits and would break both).
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
