"""Spatial-query cache between hierarchy levels (port of
``mccnn_tpu/api/builder.py::SpatialCache``, its pdf, bucket and tile parts).

Stacked convs reuse one KDE density per ``(source level, conv radius)``, as
the reference's ``ComputePDF`` cache does. With a tile capacity
(``tile_pairs``) a level of more than ``DENSE_KDE_MAX_N`` points takes the
tile KDE (K7), whose dropped-step counts wait in ``_tile_overflow`` until a
conv drains them. ``conv_backend`` forces the conv backend at every site
("auto" routes by shape, ``ops/dispatch.py``): the port's counterpart of the
reference's ``MCCNN_TPU_CONV_BACKEND`` variable, an argument here. The
bucket conv (K9 / K10) reads one cell-bucket layout per ``(level, conv
radius)``, built on first use at the reference's per-level ``default_cap``
slots a cell.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..core.buckets import BucketGrid, build_buckets, default_cap
from ..core.pdf import DENSE_KDE_MAX_N, kde_density
from .hierarchy import PointHierarchy


@dataclass
class SpatialCache:
    hierarchy: PointHierarchy
    kde_window: float = 0.25
    # Static tile-pair capacity sized for the level-0 sites; deeper levels
    # run lossless. None: no tile sites.
    tile_pairs: int | None = None
    # Measured per-site step budgets, keys ("conv", in_level, out_level, r)
    # and ("kde", level, r) with r = round(radius, 6).
    tile_steps: dict | None = None
    conv_backend: str = "auto"
    _pdf: dict = field(default_factory=dict)
    _buckets: dict = field(default_factory=dict)
    _tile_overflow: list = field(default_factory=list)

    def drain_tile_overflow(self) -> list:
        """The (B,) dropped-step counts reported since the last drain."""
        out, self._tile_overflow = self._tile_overflow, []
        return out

    def report_tile_overflow(self, overflow: torch.Tensor) -> None:
        self._tile_overflow.append(overflow)

    def site_steps(self, kind: str, *key) -> int | None:
        """Measured per-site ``max_steps`` budget, or None (worst case)."""
        if not self.tile_steps:
            return None
        *head, radius = key
        return self.tile_steps.get((kind, *head, round(float(radius), 6)))

    def buckets(self, level: int, radius: float) -> BucketGrid:
        """The level's cell-bucket layout at cell edge = ``radius``."""
        key = (level, float(radius))
        if key not in self._buckets:
            lvl = self.hierarchy.levels[level]
            cap = default_cap(lvl.points.shape[1], float(radius))
            self._buckets[key] = build_buckets(lvl.points, lvl.mask, float(radius), cap)
        return self._buckets[key]

    def pdf(self, level: int, radius: float) -> torch.Tensor:
        """KDE density of the level's points at bandwidth ``kde_window * radius``."""
        key = (level, float(radius))
        if key not in self._pdf:
            lvl = self.hierarchy.levels[level]
            if self.tile_pairs is not None and lvl.points.shape[1] > DENSE_KDE_MAX_N:
                # the capacity is sized for level 0; deeper levels run lossless
                pairs = self.tile_pairs if level == 0 else 1 << 30
                dens, ovf = kde_density(
                    lvl.points, lvl.mask, float(radius), kde_window=self.kde_window,
                    tile_pairs=pairs, max_steps=self.site_steps("kde", level, radius),
                    with_overflow=True,
                )
                self.report_tile_overflow(ovf)
                self._pdf[key] = dens
            else:
                self._pdf[key] = kde_density(
                    lvl.points, lvl.mask, float(radius), kde_window=self.kde_window
                )
        return self._pdf[key]
