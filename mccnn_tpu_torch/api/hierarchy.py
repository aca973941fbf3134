"""Multi-level point hierarchy built by Poisson-disk sampling
(port of ``mccnn_tpu/api/hierarchy.py``).

Level 0 is the input cloud; each further level is a Poisson-disk subset of the
previous one at an increasing radius, padded to a static capacity and masked.
With ``global_level=True`` a one-point level at the masked centroid closes the
hierarchy (the classification heads' global pooling level).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..core.gather import gather_rows
from ..core.neighbors import Neighborhood, self_neighbors
from ..core.sampling import DENSE_SAMPLER_MAX_N, SampleSet, poisson_disk

GLOBAL_RADIUS = math.sqrt(3.0) + 0.1  # covers the whole unit cube


class HierarchyLevel(NamedTuple):
    """One level: padded points + mask, and how it was sampled.

    ``sample`` holds indices into the PREVIOUS level (None for level 0 and
    the global level). ``self_nbh`` is the level's self-neighbourhood at the
    next level's Poisson radius when the neighbour-list sampler built one
    (else None), kept on the level as the reference keeps it.
    """

    points: torch.Tensor  # (B, N_l, 3)
    mask: torch.Tensor  # (B, N_l)
    radius: float  # Poisson radius used to build this level (0.0 for level 0)
    sample: SampleSet | None
    self_nbh: Neighborhood | None = None


class PointHierarchy(NamedTuple):
    levels: tuple[HierarchyLevel, ...]

    def __len__(self) -> int:
        return len(self.levels)


def default_level_caps(n_points: int, radii: Sequence[float]) -> list[int]:
    """Static per-level capacities (``hierarchy.py:54-68``): the min of a
    volume and a surface bound on a Poisson-disk set at radius r and the
    parent capacity, rounded up to a multiple of 8."""
    caps = []
    n_prev = n_points
    for r in radii:
        vol = (math.sqrt(3.0) / max(r, 1e-6)) ** 3
        surf = (2.2 / max(r, 1e-6)) ** 2
        cap = min(n_prev, int(min(vol, surf)) + 8)
        cap = max(8, (cap + 7) // 8 * 8)
        caps.append(cap)
        n_prev = cap
    return caps


def build_hierarchy(
    points: torch.Tensor,
    mask: torch.Tensor,
    radii: Sequence[float],
    *,
    level_caps: Sequence[int] | None = None,
    neighbor_k: int = 48,
    global_level: bool = False,
    tile_pairs: int | None = None,
    tile_steps: dict | None = None,
) -> PointHierarchy:
    """Build the Poisson-disk hierarchy of unit-cube ``points (B, N, 3)``.

    ``tile_pairs`` sends levels of more than ``TILE_SAMPLER_MIN_N`` points to
    the tile sampler; ``tile_steps`` holds measured step budgets under keys
    ``("sweep", source_level, round(radius, 6))`` (``hierarchy.py:107-180``).
    Without a tile capacity, a level of more than ``DENSE_SAMPLER_MAX_N``
    points is sampled through its self-neighbourhood of capacity
    ``neighbor_k``, which stays on the level.
    """
    if level_caps is None:
        level_caps = default_level_caps(points.shape[1], radii)
    levels = [HierarchyLevel(points=points, mask=mask, radius=0.0, sample=None)]
    cur_pts, cur_mask = points, mask
    for lvl, (r, cap) in enumerate(zip(radii, level_caps)):
        max_steps = None
        if tile_steps:
            max_steps = tile_steps.get(("sweep", lvl, round(float(r), 6)))
        nbh = None
        if cur_pts.shape[1] > DENSE_SAMPLER_MAX_N and tile_pairs is None:
            nbh = self_neighbors(cur_pts, cur_mask, r, neighbor_k)
        ss = poisson_disk(cur_pts, cur_mask, r, cap, neighborhood=nbh, tile_pairs=tile_pairs,
                          max_steps=max_steps)
        nxt_pts = torch.where(ss.mask[..., None], gather_rows(cur_pts, ss.idx), 0.0)
        levels[-1] = levels[-1]._replace(self_nbh=nbh)
        levels.append(
            HierarchyLevel(points=nxt_pts, mask=ss.mask, radius=float(r), sample=ss)
        )
        cur_pts, cur_mask = nxt_pts, ss.mask
    if global_level:
        m = cur_mask[..., None].to(cur_pts.dtype)
        denom = m.sum(dim=1).clamp_min(1.0)
        centroid = (cur_pts * m).sum(dim=1, keepdim=True) / denom[:, None, :]
        any_valid = cur_mask.any(dim=-1, keepdim=True)
        levels.append(
            HierarchyLevel(points=centroid, mask=any_valid, radius=GLOBAL_RADIUS, sample=None)
        )
    return PointHierarchy(levels=tuple(levels))
