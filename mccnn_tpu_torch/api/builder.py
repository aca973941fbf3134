"""Spatial-query cache between hierarchy levels (port of the pdf part of
``mccnn_tpu/api/builder.py::SpatialCache``).

Stacked convs reuse one KDE density per ``(source level, conv radius)``, as
the reference's ``ComputePDF`` cache does. Neighbourhoods, buckets and tiles
come with the ports of their kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..core.pdf import kde_density
from .hierarchy import PointHierarchy


@dataclass
class SpatialCache:
    hierarchy: PointHierarchy
    kde_window: float = 0.25
    _pdf: dict = field(default_factory=dict)

    def pdf(self, level: int, radius: float) -> torch.Tensor:
        """KDE density of the level's points at bandwidth ``kde_window * radius``."""
        key = (level, float(radius))
        if key not in self._pdf:
            lvl = self.hierarchy.levels[level]
            self._pdf[key] = kde_density(
                lvl.points, lvl.mask, float(radius), kde_window=self.kde_window
            )
        return self._pdf[key]
