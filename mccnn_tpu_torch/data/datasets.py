"""Host-side cloud preparation, the ModelNet40 classification source, the
ShapeNet-part source and the ScanNet scene source, numpy only (port of
``mccnn_tpu/data/datasets.py``).

The port's own copy: it imports nothing of the JAX package. Every batch is a
dict of numpy arrays, ``points (B, N, 3)`` normalised to the unit cube, ``mask
(B, N)`` and the task's fields (``labels``; ShapeNet adds
``category_onehot (B, n_categories)``).

The ``batches`` methods are the reference's numpy branches
(``datasets.py:119-141``, ``:236-255``). The reference's default goes through
its native C++ host pipe (``mccnn_tpu/native/hostpipe.cpp``) for the uniform
protocol, whose random stream differs; that host code is still to port
(ROADMAP queue 1), so the port always takes the numpy branch (the
reference's with ``MCCNN_HOST_PIPE=numpy``).
"""

from __future__ import annotations

import json
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


@dataclass
class PartSegSource:
    """ShapeNet-part: clouds, per-point part labels and a category per cloud
    (``datasets.py:173-255``, its numpy branch)."""

    clouds: list  # list of (n_i, 3) float32
    point_labels: list  # list of (n_i,) int32
    categories: np.ndarray  # (n_models,) int32
    n_categories: int
    n_parts: int

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
    ) -> Iterator[dict]:
        """Draw ``n_points`` per cloud under ``protocol`` (rotation about z and
        jitter with ``train_augment``, no scaling), normalise, and carry the
        drawn points' part labels and the category as a one-hot."""
        order = np.arange(len(self.clouds))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                return
            pts_b, lab_b, cat_b = [], [], []
            for i in chunk:
                cloud = self.clouds[i]
                idx = draw(protocol, cloud, n_points, rng)
                p = cloud[idx]
                if train_augment:
                    p = augment.rotate_z(p, rng)
                    p = augment.jitter(p, rng)
                pts_b.append(_normalize_np(p))
                lab_b.append(self.point_labels[i][idx])
                cat_b.append(self.categories[i])
            cat = np.asarray(cat_b, np.int32)
            yield {
                "points": np.stack(pts_b),
                "mask": np.ones((len(chunk), n_points), bool),
                "labels": np.stack(lab_b).astype(np.int32),
                "category_onehot": np.eye(self.n_categories, dtype=np.float32)[cat],
            }


def load_shapenet_part(root: str, split: str = "train") -> PartSegSource:
    """The ``shapenetcore_partanno_segmentation_benchmark_v0`` layout
    (``datasets.py:258-300``): ``<synset>/points/<id>.pts``,
    ``<synset>/points_label/<id>.seg`` (1-based part labels) and
    ``train_test_split/shuffled_{split}_file_list.json`` of
    ``shape_data/<synset>/<id>`` entries. Categories are the sorted synset
    directories; ``n_parts`` is the largest label seen."""
    split_file = os.path.join(root, "train_test_split", f"shuffled_{split}_file_list.json")
    if not os.path.exists(split_file):
        raise FileNotFoundError(
            f"ShapeNet-part not found at {root} — expected the "
            "'shapenetcore_partanno_segmentation_benchmark_v0' layout. Use "
            "--synthetic for smoke runs without data."
        )
    from ..utils.io import read_points_txt

    with open(split_file) as f:
        files = json.load(f)
    synsets = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)) and d.isdigit())
    syn_index = {s: i for i, s in enumerate(synsets)}
    clouds, labels, cats = [], [], []
    max_part = 0
    for entry in files:
        _, synset, mid = entry.split("/")
        clouds.append(read_points_txt(os.path.join(root, synset, "points", mid + ".pts")))
        seg_path = os.path.join(root, synset, "points_label", mid + ".seg")
        seg = (np.loadtxt(seg_path, dtype=np.int32, ndmin=1).reshape(-1) - 1).astype(np.int32)
        labels.append(seg)
        cats.append(syn_index[synset])
        max_part = max(max_part, int(seg.max()) + 1)
    return PartSegSource(
        clouds=clouds,
        point_labels=labels,
        categories=np.asarray(cats, np.int32),
        n_categories=len(synsets),
        n_parts=max_part,
    )


@dataclass
class SceneSegSource:
    """ScanNet-style scene segmentation: big scenes chopped into blocks
    (port of ``datasets.py:304-389``, its numpy branch).

    A block is a random xy column of ``block_size`` around a random scene
    point, resampled to ``n_points`` and normalised to the unit cube. The
    reference's default goes through its native host pipe, whose random
    stream differs; that host code is still to port (ROADMAP queue 1)."""

    scenes: list  # list of (n_i, 3) float32
    labels: list  # list of (n_i,) int32
    n_classes: int
    block_size: float = 1.5

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
        blocks_per_epoch: int | None = None,
    ) -> Iterator[dict]:
        n_blocks = blocks_per_epoch or max(len(self.scenes), batch_size)
        scene_ids = rng.integers(0, len(self.scenes), size=n_blocks)
        for start in range(0, n_blocks, batch_size):
            chunk = scene_ids[start : start + batch_size]
            if len(chunk) < batch_size and drop_remainder:
                return
            pts_b, lab_b, mask_b = [], [], []
            for si in chunk:
                pts, lab = self.scenes[si], self.labels[si]
                for _ in range(10):  # retry until a non-empty block
                    center = pts[rng.integers(0, len(pts)), :2]
                    half = self.block_size / 2.0
                    sel = np.nonzero(
                        (np.abs(pts[:, 0] - center[0]) <= half)
                        & (np.abs(pts[:, 1] - center[1]) <= half)
                    )[0]
                    if len(sel) >= 32:
                        break
                p, m, idx = pad_points(pts[sel], n_points, rng)
                if train_augment:
                    p = augment.rotate_z(p, rng)
                    p = augment.jitter(p, rng, sigma=0.005, clip=0.02)
                pts_b.append(_normalize_np(p))
                lab_b.append(lab[sel][idx])
                mask_b.append(m)
            yield {
                "points": np.stack(pts_b),
                "mask": np.stack(mask_b),
                "labels": np.stack(lab_b).astype(np.int32),
            }


def load_scannet(root: str, split: str = "train") -> SceneSegSource:
    """``scannet_{split}.npz`` with object arrays ``scenes`` and ``labels``."""
    path = os.path.join(root, f"scannet_{split}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"ScanNet not found at {path} — expected scannet_{{split}}.npz with object "
            "arrays 'scenes' and 'labels'. Use --synthetic for smoke runs without data."
        )
    data = np.load(path, allow_pickle=True)
    scenes = list(data["scenes"])
    labels = list(data["labels"])
    n_classes = int(max(int(l.max()) for l in labels)) + 1
    return SceneSegSource(scenes=scenes, labels=labels, n_classes=n_classes)


def class_weights_from(labels: list, n_classes: int) -> np.ndarray:
    """Inverse-log-frequency class weights (``datasets.py:406``)."""
    counts = np.zeros(n_classes, np.int64)
    for l in labels:
        counts += np.bincount(l, minlength=n_classes)
    freq = counts / max(counts.sum(), 1)
    return (1.0 / np.log(1.2 + freq + 1e-12)).astype(np.float32)
