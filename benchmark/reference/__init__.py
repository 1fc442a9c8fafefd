"""The plain reference of the benchmark: the 2-view and N-view
reconstruction in plain PyTorch, as the stages of
``ssrlcv_tpu_torch.pipeline.stages`` define it.

A frozen copy of the port's plain code at the commit that added the
benchmark (its configuration, types, camera math, image ops, SIFT,
matching, triangulation, filters and bundle adjustment), with its imports
rewritten to this package and every kernel wrapper replaced by its plain
version on every device (K1 ``orientation_histograms_plain``, K2
``descriptor_histograms_plain``, K3 ``best_target_plain``).  It imports
nothing of ``ssrlcv_tpu_torch``, ``ssrlcv_tpu`` or ``jax`` and takes nothing
the program made: ``pipeline.reconstruct`` works from the images and
cameras the benchmark made.

Float32 products and convolutions are pinned to full float32 (no TF32).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
