"""Poisson-disk sampling for the point hierarchy (port of ``mccnn_tpu/core/sampling.py``).

A maximal Poisson-disk selection in 27 colour steps: cells of edge
``r / sqrt(3)`` hold at most one selected point, and cells of one colour
``(cx%3, cy%3, cz%3)`` can never conflict, so each step accepts every cell's
lowest-index uncovered point of the current colour at once (see the
reference's module docstring for the argument).

Three of the reference's sweeps are ported, routed as there
(``sampling.py:138-151``):

* N > ``TILE_SAMPLER_MIN_N`` with a tile capacity: ``_poisson_tiles``, the
  cell-Hilbert tile sweep, whose per-colour "newly covered" query is the K8
  cover count (``ops/cuda/tile_conv.py::TileCoverSweep``);
* N <= ``DENSE_SAMPLER_MAX_N``: the dense sweep, K3
  (``ops/cuda/poisson_kernel.py``); up to ``VARIANT_MAX_N`` = 1024 points,
  where the reference runs its Pallas sweep (``sampling.py:133``),
  ``MCCNN_POISSON_SWEEP`` may pick the variant K3v2, K3v3 or K3v4 instead;
* larger N without a tile capacity: the neighbour-list sweep
  (``_poisson_neighbor_lists``), whose "newly covered" query reads each
  point's K nearest neighbours (``core/neighbors.py``), so that coverage can
  be under-reported past K, as in the reference. It is plain tensor code on
  either device, as the reference's is ``jnp``.

The first two run their kernel for a CUDA tensor and their plain version for
a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda.poisson_kernel import VARIANT_MAX_N, poisson_sweep
from ..ops.cuda.tile_conv import (
    DEFAULT_COVER_CHUNK,
    count_self_steps,
    hilbert_code,
    make_cover_sweep,
)
from .grid import cell_color27, cell_coords, grid_res_for_radius, linear_cell_ids
from .neighbors import Neighborhood, self_neighbors

_SQRT3 = 3.0**0.5
_BIG_I32 = 2**30
DENSE_SAMPLER_MAX_N = 4096  # mccnn_tpu/core/sampling.py:74
TILE_SAMPLER_MIN_N = 2048  # mccnn_tpu/core/sampling.py:79


class SampleSet(NamedTuple):
    """A padded subset of the input points.

    Attributes:
      idx: ``(B, S)`` int64 indices into the input point axis (0 where masked).
      mask: ``(B, S)`` bool — True for real selections.
      selected: ``(B, N)`` bool — dense selection flags over the inputs.
      overflow: ``(B,)`` dropped tile steps of the tile sweep (None on the
        dense sweep). Nonzero means coverage queries missed pairs.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    selected: torch.Tensor
    overflow: torch.Tensor | None = None


def _sampler_grid(points: torch.Tensor, radius: float):
    """Integer cell coordinates and the grid resolution (``sampling.py:123-125``)."""
    cell_edge = float(radius) / _SQRT3
    res = grid_res_for_radius(radius, cell_scale=1.0 / _SQRT3)
    return cell_coords(points, cell_edge, res), res


def sweep_cells(points: torch.Tensor, radius: float):
    """Sampler cell ids and 27-colours of each point (``sampling.py:123-127``)."""
    coords, res = _sampler_grid(points, radius)
    return linear_cell_ids(coords, res), cell_color27(coords)


def poisson_disk(
    points: torch.Tensor, mask: torch.Tensor, radius: float, max_samples: int, *,
    neighborhood: Neighborhood | None = None, k: int = 48,
    tile_pairs: int | None = None, max_steps: int | None = None,
) -> SampleSet:
    """Maximal Poisson-disk subset with min pairwise distance ``radius``.

    ``points`` lie in the unit cube; selections beyond ``max_samples`` are
    dropped in index order. ``tile_pairs`` (with ``max_steps``, a measured
    step budget) routes N > ``TILE_SAMPLER_MIN_N`` to the tile sweep.
    ``neighborhood`` (the self-neighbourhood at ``radius``) or, when it is
    None, one of capacity ``k`` built here serves the neighbour-list sweep.
    """
    B, N, _ = points.shape
    coords, res = _sampler_grid(points, radius)
    cids, colors = linear_cell_ids(coords, res), cell_color27(coords)
    overflow = None
    if tile_pairs is not None and N > TILE_SAMPLER_MIN_N:
        selected, overflow = _poisson_tiles(points, mask, coords, cids, colors, radius, res,
                                            tile_pairs, max_steps)
    elif N <= DENSE_SAMPLER_MAX_N:
        variant = None if N <= VARIANT_MAX_N else "v1"  # the switch's range
        selected = poisson_sweep(points, mask, cids, colors, radius, variant)
    else:
        if neighborhood is None:
            neighborhood = self_neighbors(points, mask, radius, k)
        selected = _poisson_neighbor_lists(cids, colors, mask, neighborhood, res**3, N)
    selected = selected & mask

    # Compact the flags into (B, S) indices in ascending index order.
    point_index = torch.arange(N, device=points.device).expand(B, N)
    sort_key = torch.where(selected, point_index, _BIG_I32)
    order = torch.argsort(sort_key, dim=-1, stable=True)[:, :max_samples]
    out_mask = torch.gather(sort_key, 1, order) < _BIG_I32
    idx = torch.where(out_mask, order, 0)
    return SampleSet(idx=idx, mask=out_mask, selected=selected, overflow=overflow)


def _poisson_neighbor_lists(cids, colors, mask, neighborhood: Neighborhood, n_cells: int,
                            N: int) -> torch.Tensor:
    """The K-capacity neighbour-list sweep (``sampling.py:313-343``): per
    colour, each cell's lowest-index uncovered point of that colour is
    selected (a per-cell ``amin`` over ``n_cells`` cells), and a point is
    newly covered when any of its listed neighbours (itself included) is
    selected."""
    B = cids.shape[0]
    dev = cids.device
    cid = cids.long()
    point_index = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    nbr_idx = neighborhood.idx.reshape(B, -1)
    selected = torch.zeros((B, N), dtype=torch.bool, device=dev)
    covered = torch.zeros_like(selected)
    for c in range(27):
        uncovered = mask & ~covered
        key = torch.where(uncovered, point_index, _BIG_I32)
        cell_min = torch.full((B, n_cells), _BIG_I32, dtype=torch.int32, device=dev)
        cell_min = cell_min.scatter_reduce(1, cid, key, "amin")
        cand = uncovered & (key == torch.gather(cell_min, 1, cid)) & (colors == c)
        selected = selected | cand
        nbr_sel = torch.gather(selected, 1, nbr_idx).reshape(neighborhood.mask.shape)
        covered = covered | (nbr_sel & neighborhood.mask).any(dim=-1)
    return selected


def _cell_hilbert_order(coords, mask, res):
    """Stable point order by the Hilbert index of each point's sampler cell
    (``sampling.py:201``): every cell becomes one contiguous run, in
    ascending original index."""
    bits = max(1, (res - 1).bit_length())
    assert bits * 3 <= 30, f"sampler cell grid too fine: res={res}"
    code = hilbert_code(coords.clamp(0, (1 << bits) - 1).to(torch.int32), bits)
    code = torch.where(mask, code, _BIG_I32)
    return torch.argsort(code, dim=-1, stable=True)


def count_poisson_sweep_steps(points, mask, radius) -> torch.Tensor:
    """(B,) chunked-step demand of the tile sampler's cover sweeps on these
    inputs: the exact lossless ``max_steps`` (``sampling.py:216``)."""
    coords, res = _sampler_grid(points, radius)
    order = _cell_hilbert_order(coords, mask, res)
    return count_self_steps(points, mask, radius, order, chunk=DEFAULT_COVER_CHUNK)


def _poisson_tiles(points, mask, coords, cids, colors, radius, res, tile_pairs,
                   max_steps=None):
    """The cell-run tile 27-colour sweep (``sampling.py:247``).

    Points are sorted by the Hilbert index of their sampler cell, so each cell
    is one run in ascending original index; a colour's candidates are then
    the first uncovered point of each run (a cumsum and a running max, all in
    sorted order), and "newly covered" is one cover count per colour (K8)."""
    B, N, _ = points.shape
    order = _cell_hilbert_order(coords, mask, res)
    sweep = make_cover_sweep(points, mask, radius, max_pairs=tile_pairs, order=order,
                             max_steps=max_steps)
    nt_rows = sweep.valid.shape[1]

    def sort1(x):
        s = torch.gather(x, 1, order)
        return torch.cat([s, s.new_full((B, nt_rows - N), -1)], dim=1)

    s_cids = sort1(cids)  # padding joins no real run
    s_colors = sort1(colors)  # padding matches no colour
    s_mask = sweep.valid
    seg_start = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=points.device),
         s_cids[:, 1:] != s_cids[:, :-1]], dim=1)
    selected = torch.zeros((B, nt_rows), dtype=torch.bool, device=points.device)
    covered = torch.zeros_like(selected)
    for c in range(27):
        uncovered = s_mask & ~covered
        u = uncovered.to(torch.int32)
        excl = torch.cumsum(u, dim=1, dtype=torch.int32) - u  # uncovered strictly before
        base = torch.cummax(torch.where(seg_start, excl, -1), dim=1).values
        cand = uncovered & (excl == base) & (s_colors == c)
        selected = selected | cand
        covered = covered | (sweep.counts(cand) > 0)
    out = torch.empty((B, N), dtype=torch.bool, device=points.device)
    out.scatter_(1, order, selected[:, :N])
    return out, sweep.overflow
