"""Synthetic point clouds for smoke runs, numpy only
(port of ``mccnn_tpu/data/synthetic.py``).

The port's own copy: it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

_PRIMS = ("sphere", "cube", "cylinder", "cone", "torus", "pyramid")


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def primitive_cloud(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """Surface-sampled primitive in [-1, 1]^3 (float32)."""
    if kind == "sphere":
        p = _unit(rng, n)
    elif kind == "cube":
        p = rng.uniform(-1, 1, size=(n, 3))
        ax = rng.integers(0, 3, size=n)
        sign = rng.choice([-1.0, 1.0], size=n)
        p[np.arange(n), ax] = sign
    elif kind == "cylinder":
        a = rng.uniform(0, 2 * np.pi, size=n)
        z = rng.uniform(-1, 1, size=n)
        p = np.stack([np.cos(a), np.sin(a), z], -1)
    elif kind == "cone":
        a = rng.uniform(0, 2 * np.pi, size=n)
        t = np.sqrt(rng.uniform(0, 1, size=n))
        p = np.stack([t * np.cos(a), t * np.sin(a), 1.0 - 2.0 * t], -1)
    elif kind == "torus":
        a = rng.uniform(0, 2 * np.pi, size=n)
        b = rng.uniform(0, 2 * np.pi, size=n)
        R, r = 0.8, 0.3
        p = np.stack(
            [
                (R + r * np.cos(b)) * np.cos(a),
                (R + r * np.cos(b)) * np.sin(a),
                r * np.sin(b),
            ],
            -1,
        )
    elif kind == "pyramid":
        t = rng.uniform(0, 1, size=n)
        base = rng.uniform(-1, 1, size=(n, 2))
        p = np.stack(
            [base[:, 0] * (1 - t), base[:, 1] * (1 - t), 2 * t - 1], -1
        )
    else:
        raise ValueError(kind)
    return p.astype(np.float32)


def classification_batch(
    rng: np.random.Generator,
    batch: int,
    n_points: int,
    n_classes: int = 6,
):
    """(points (B,N,3) in [-1,1], labels (B,)) — class = primitive kind."""
    labels = rng.integers(0, min(n_classes, len(_PRIMS)), size=batch)
    pts = np.stack(
        [primitive_cloud(_PRIMS[l], n_points, rng) for l in labels]
    )
    return pts, labels.astype(np.int32)


def segmentation_batch(rng: np.random.Generator, batch: int, n_points: int, n_parts: int = 4):
    """(points, per-point part labels): a primitive cut into ``n_parts`` slabs
    along z (``synthetic.py:75``)."""
    pts, _ = classification_batch(rng, batch, n_points)
    edges = np.linspace(-1.0, 1.0, n_parts + 1)[1:-1]
    return pts, np.digitize(pts[..., 2], edges).astype(np.int32)


def normals_batch(rng: np.random.Generator, batch: int, n_points: int):
    """Spheres with their analytic normals, the position's direction
    (``synthetic.py:86``)."""
    pts = np.stack([primitive_cloud("sphere", n_points, rng) for _ in range(batch)])
    normals = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    return pts, normals.astype(np.float32)
