"""Point-cloud augmentation, numpy only (port of ``mccnn_tpu/data/augment.py``).

The port's own copy: it imports nothing of the JAX package. The reference
parity is the augmentation half of viscom-ulm/MCCNN's ``utils/DataSet.py``:
rotation, jitter, anisotropic scaling and point dropout, run on the host.
"""

from __future__ import annotations

import numpy as np


def rotate_z(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random rotation about the up (z) axis — the ModelNet default."""
    a = rng.uniform(0.0, 2.0 * np.pi)
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], points.dtype)
    return points @ rot.T


def rotate_small(
    points: np.ndarray, rng: np.random.Generator, angle_sigma=0.06, angle_clip=0.18
) -> np.ndarray:
    """Small random rotation about all axes (perturbation augmentation)."""
    angles = np.clip(
        rng.normal(0.0, angle_sigma, size=3), -angle_clip, angle_clip
    )
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (points @ (rz @ ry @ rx).T).astype(points.dtype)


def jitter(
    points: np.ndarray, rng: np.random.Generator, sigma=0.01, clip=0.05
) -> np.ndarray:
    noise = np.clip(rng.normal(0.0, sigma, size=points.shape), -clip, clip)
    return (points + noise).astype(points.dtype)


def anisotropic_scale(
    points: np.ndarray, rng: np.random.Generator, lo=0.9, hi=1.1
) -> np.ndarray:
    return (points * rng.uniform(lo, hi, size=(1, 3))).astype(points.dtype)


def random_point_dropout(
    points: np.ndarray, rng: np.random.Generator, max_ratio=0.3
) -> np.ndarray:
    """Replace a random fraction of points with the first point (keeps static
    shape — the reference's ptDropOut-style augmentation)."""
    ratio = rng.uniform(0.0, max_ratio)
    drop = rng.random(len(points)) < ratio
    out = points.copy()
    out[drop] = points[0]
    return out


def batch_point_dropout(
    points: np.ndarray, rng: np.random.Generator, max_ratio=0.3
) -> np.ndarray:
    """Vectorized ``random_point_dropout`` over a (B, N, 3) batch with an
    independent drop ratio per element (the post-assembly form used after
    the native C++ pipeline, which returns the whole batch at once)."""
    B, N = points.shape[:2]
    ratio = rng.uniform(0.0, max_ratio, size=(B, 1))
    drop = rng.random((B, N)) < ratio
    out = points.copy()
    out[drop] = np.repeat(points[:, 0:1], N, axis=1)[drop]
    return out
