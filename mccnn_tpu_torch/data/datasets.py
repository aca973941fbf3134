"""Host-side cloud preparation and the ModelNet40 classification source, numpy
only (port of ``mccnn_tpu/data/datasets.py:38-170``).

The port's own copy: it imports nothing of the JAX package. Every batch is a
dict of numpy arrays, ``points (B, N, 3)`` normalised to the unit cube, ``mask
(B, N)`` and ``labels (B,)``.

``ClassificationSource.batches`` is the reference's numpy branch
(``datasets.py:119-141``). The reference's default goes through its native
C++ host pipe (``mccnn_tpu/native/hostpipe.cpp``) for the uniform protocol,
whose random stream differs; that host code is still to port (ROADMAP queue
1), so the port always takes the numpy branch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from . import augment
from .sampling_protocols import draw


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


@dataclass
class ClassificationSource:
    """In-memory classification dataset: full-resolution clouds + labels."""

    clouds: list  # list of (n_i, 3) float32
    normals: list  # list of (n_i, 3) or None
    labels: np.ndarray  # (n_models,)
    class_names: list

    def batches(
        self,
        batch_size: int,
        n_points: int,
        rng: np.random.Generator,
        *,
        shuffle: bool = True,
        train_augment: bool = False,
        protocol: str = "uniform",
        drop_remainder: bool = True,
        pt_drop_max: float = 0.0,
    ) -> Iterator[dict]:
        """Draw ``n_points`` per cloud under ``protocol``; with
        ``train_augment``, rotate about z, jitter and scale, then normalise;
        ``pt_drop_max > 0`` then collapses a random fraction (up to it) of
        each cloud onto its first point (the reference's ptDropOut)."""
        order = np.arange(len(self.clouds))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                return
            pts_b, mask_b, lab_b = [], [], []
            for i in chunk:
                cloud = self.clouds[i]
                idx = draw(protocol, cloud, n_points, rng, normals=self.normals[i])
                p = cloud[idx]
                if train_augment:
                    p = augment.rotate_z(p, rng)
                    p = augment.jitter(p, rng)
                    p = augment.anisotropic_scale(p, rng)
                p = _normalize_np(p)
                if train_augment and pt_drop_max > 0.0:
                    p = augment.random_point_dropout(p, rng, max_ratio=pt_drop_max)
                pts_b.append(p)
                mask_b.append(np.ones(n_points, bool))
                lab_b.append(self.labels[i])
            yield {
                "points": np.stack(pts_b),
                "mask": np.stack(mask_b),
                "labels": np.asarray(lab_b, np.int32),
            }


def load_modelnet40(root: str, split: str = "train") -> ClassificationSource:
    """The ``modelnet40_normal_resampled`` layout: one ``<name>.txt`` of
    ``x,y,z,nx,ny,nz`` rows per model, ``modelnet40_shape_names.txt`` and
    ``modelnet40_{train,test}.txt``."""
    names_file = os.path.join(root, "modelnet40_shape_names.txt")
    split_file = os.path.join(root, f"modelnet40_{split}.txt")
    if not os.path.exists(split_file):
        raise FileNotFoundError(
            f"ModelNet40 not found at {root} — expected the "
            "'modelnet40_normal_resampled' layout. Use --synthetic for smoke "
            "runs without data."
        )
    from ..utils.io import read_points_txt

    with open(names_file) as f:
        class_names = [l.strip() for l in f if l.strip()]
    cls_index = {c: i for i, c in enumerate(class_names)}
    with open(split_file) as f:
        model_ids = [l.strip() for l in f if l.strip()]
    clouds, normals, labels = [], [], []
    for mid in model_ids:
        cls = "_".join(mid.split("_")[:-1])
        arr = read_points_txt(os.path.join(root, cls, mid + ".txt"))
        clouds.append(np.ascontiguousarray(arr[:, :3]))
        normals.append(np.ascontiguousarray(arr[:, 3:6]) if arr.shape[1] >= 6 else None)
        labels.append(cls_index[cls])
    return ClassificationSource(
        clouds=clouds,
        normals=normals,
        labels=np.asarray(labels, np.int32),
        class_names=class_names,
    )
