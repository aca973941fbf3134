"""Non-uniform sampling protocols for the robustness experiments, numpy only
(port of ``mccnn_tpu/data/sampling_protocols.py``).

The port's own copy: it imports nothing of the JAX package. Each protocol
takes the full point set of a model and draws a biased subset of ``n``
indices (``gradient``, ``split``, ``lambert``, ``occlusion``; Hermosilla et al.
2018, section 6), simulating real-sensor density variation.
"""

from __future__ import annotations

import numpy as np

PROTOCOLS = ("uniform", "gradient", "split", "lambert", "occlusion")


def _choice(rng, n_points, n, p=None):
    p = None if p is None else p / p.sum()
    replace = n > n_points
    return rng.choice(n_points, size=n, replace=replace, p=p)


def sample_uniform(points, n, rng, normals=None):
    return _choice(rng, len(points), n)


def sample_gradient(points, n, rng, normals=None, min_prob=0.05):
    """Keep probability rises linearly along a random axis direction."""
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    t = points @ d
    t = (t - t.min()) / max(t.max() - t.min(), 1e-9)
    return _choice(rng, len(points), n, p=min_prob + (1.0 - min_prob) * t)


def sample_split(points, n, rng, normals=None, ratio=0.25):
    """One half-space keeps full density, the other only ``ratio``."""
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    side = (points - points.mean(0)) @ d > 0
    p = np.where(side, 1.0, ratio)
    return _choice(rng, len(points), n, p=p)


def sample_lambert(points, n, rng, normals=None):
    """Density proportional to the cosine between the surface normal and a
    random view direction (back-facing points vanish) — a LIDAR-ish model.
    Falls back to the direction from the centroid when normals are absent."""
    v = rng.normal(size=3)
    v /= np.linalg.norm(v)
    if normals is not None:
        cos = normals @ v
    else:
        d = points - points.mean(0)
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
        cos = d @ v
    p = np.maximum(cos, 0.0) + 1e-3
    return _choice(rng, len(points), n, p=p)


def sample_occlusion(points, n, rng, normals=None, bins=32):
    """Keep only points visible from a random viewpoint: project onto an
    angular grid around the viewpoint and keep the nearest shell per bin,
    then draw uniformly from the visible set."""
    v = rng.normal(size=3)
    v /= np.linalg.norm(v)
    eye = points.mean(0) + v * 3.0 * np.abs(points - points.mean(0)).max()
    d = points - eye
    r = np.linalg.norm(d, axis=-1)
    d = d / r[:, None]
    theta = np.arccos(np.clip(d[:, 2], -1.0, 1.0))
    phi = np.arctan2(d[:, 1], d[:, 0])
    bt = np.clip((theta / np.pi * bins).astype(int), 0, bins - 1)
    bp = np.clip(((phi + np.pi) / (2 * np.pi) * bins).astype(int), 0, bins - 1)
    key = bt * bins + bp
    # nearest distance per angular bin; points within 10% of it are "visible"
    uniq, inv = np.unique(key, return_inverse=True)
    min_per = np.full(len(uniq), np.inf)
    np.minimum.at(min_per, inv, r)
    visible = r <= min_per[inv] * 1.1
    idx = np.nonzero(visible)[0]
    if len(idx) == 0:
        idx = np.arange(len(points))
    return idx[_choice(rng, len(idx), n)]


SAMPLERS = {
    "uniform": sample_uniform,
    "gradient": sample_gradient,
    "split": sample_split,
    "lambert": sample_lambert,
    "occlusion": sample_occlusion,
}


def draw(protocol: str, points, n, rng, normals=None):
    """Draw ``n`` indices from ``points`` under the given protocol."""
    return SAMPLERS[protocol](points, n, rng, normals=normals)
