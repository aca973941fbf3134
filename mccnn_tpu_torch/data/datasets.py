"""Host-side cloud preparation, numpy only.

Duplicated from ``mccnn_tpu/data/datasets.py:38-55`` only until that module
drops its unused JAX import (``datasets.py:33``): importing ``mccnn_tpu.data``
pulls in JAX, which the port must not. Delete this copy when that lands.
"""

from __future__ import annotations

import numpy as np


def _normalize_np(points: np.ndarray) -> np.ndarray:
    """Center + scale into the unit cube (scale-invariant, aspect kept)."""
    mn, mx = points.min(0), points.max(0)
    scale = max(float((mx - mn).max()), 1e-9)
    return ((points - mn) / scale).astype(np.float32)


def pad_points(points: np.ndarray, n: int, rng: np.random.Generator):
    """Sample-with-replacement up to n (mask True); subsample without
    replacement when the cloud has more than n points."""
    if len(points) >= n:
        idx = rng.choice(len(points), size=n, replace=False)
        return points[idx], np.ones(n, bool), idx
    idx = np.concatenate(
        [np.arange(len(points)), rng.choice(len(points), n - len(points))]
    )
    return points[idx], np.ones(n, bool), idx
