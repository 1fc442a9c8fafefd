"""The reference's roadmap feature surface: FAST, SURF and a k-d tree.

Counterpart of ``ssrlcv_tpu/features/roadmap.py``: FAST is implemented
(``fast.detect_fast``), SURF raises as an unimplemented stub, and the k-d
tree is an exact host-side nearest-neighbour query through scipy.
"""

from __future__ import annotations


def fast_feature_factory(*args, **kwargs):
    """FAST corners: ``ssrlcv_tpu_torch.features.fast.detect_fast``."""
    from ssrlcv_tpu_torch.features.fast import detect_fast

    return detect_fast(*args, **kwargs)


def surf_feature_factory(*args, **kwargs):
    """SURF: not implemented (an empty stub in the reference)."""
    raise NotImplementedError(
        "SURF is a roadmap stub in the reference (need_implementing/"
        "SURF_FeatureFactory.cuh) and is not implemented here either."
    )


def kdtree(points, query, k: int = 8):
    """The k nearest ``points`` of each ``query`` row, exact, on the host:
    (distances, indices) as scipy's cKDTree returns them."""
    import numpy as np
    from scipy.spatial import cKDTree

    return cKDTree(np.asarray(points)).query(np.asarray(query), k=k)
