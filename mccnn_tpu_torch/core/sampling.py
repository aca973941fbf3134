"""Poisson-disk sampling for the point hierarchy (port of ``mccnn_tpu/core/sampling.py``).

A maximal Poisson-disk selection in 27 colour steps: cells of edge
``r / sqrt(3)`` hold at most one selected point, and cells of one colour
``(cx%3, cy%3, cz%3)`` can never conflict, so each step accepts every cell's
lowest-index uncovered point of the current colour at once (see the
reference's module docstring for the argument).

The sweep is ``ops/cuda/poisson_kernel.py``: the K3 kernel for a CUDA tensor,
the plain ``_poisson_dense`` twin for a CPU tensor. The reference's tile
sweep (N > 2048 with a tile capacity) and neighbour-list sweep (N > 4096)
are not ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda.poisson_kernel import poisson_sweep
from .grid import cell_color27, cell_coords, grid_res_for_radius, linear_cell_ids

_SQRT3 = 3.0**0.5
_BIG_I32 = 2**30
DENSE_SAMPLER_MAX_N = 4096  # mccnn_tpu/core/sampling.py:74


class SampleSet(NamedTuple):
    """A padded subset of the input points.

    Attributes:
      idx: ``(B, S)`` int64 indices into the input point axis (0 where masked).
      mask: ``(B, S)`` bool — True for real selections.
      selected: ``(B, N)`` bool — dense selection flags over the inputs.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    selected: torch.Tensor


def sweep_cells(points: torch.Tensor, radius: float):
    """Sampler cell ids and 27-colours of each point (``sampling.py:123-127``)."""
    cell_edge = float(radius) / _SQRT3
    res = grid_res_for_radius(radius, cell_scale=1.0 / _SQRT3)
    coords = cell_coords(points, cell_edge, res)
    return linear_cell_ids(coords, res), cell_color27(coords)


def poisson_disk(
    points: torch.Tensor, mask: torch.Tensor, radius: float, max_samples: int
) -> SampleSet:
    """Maximal Poisson-disk subset with min pairwise distance ``radius``.

    ``points`` lie in the unit cube; selections beyond ``max_samples`` are
    dropped in index order.
    """
    B, N, _ = points.shape
    if N > DENSE_SAMPLER_MAX_N:
        raise NotImplementedError(
            f"poisson_disk: N={N} > {DENSE_SAMPLER_MAX_N} takes the reference's "
            "tile or neighbour-list sampler, ported with the big-scene slice"
        )
    cids, colors = sweep_cells(points, radius)
    selected = poisson_sweep(points, mask, cids, colors, radius) & mask

    # Compact the flags into (B, S) indices in ascending index order.
    point_index = torch.arange(N, device=points.device).expand(B, N)
    sort_key = torch.where(selected, point_index, _BIG_I32)
    order = torch.argsort(sort_key, dim=-1, stable=True)[:, :max_samples]
    out_mask = torch.gather(sort_key, 1, order) < _BIG_I32
    idx = torch.where(out_mask, order, 0)
    return SampleSet(idx=idx, mask=out_mask, selected=selected)
