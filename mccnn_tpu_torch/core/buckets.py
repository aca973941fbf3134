"""The cell-bucket layout of the bucket MC conv (port of ``mccnn_tpu/core/buckets.py``).

Points are scattered into a regular grid of cells of edge = conv radius, each
cell holding up to ``cap`` point slots, with one ghost cell layer on every
side. For a real cell, the 27 cells that bound a radius search are then 9
contiguous runs of 3 cells in the z-major flattened array, and no window
needs clamping at the grid's edge (a clamped window would count a cell
twice). The bucket conv (``ops/cuda/mcconv_kernel.py``, K9 and K10) walks
these windows.

Overflow: points beyond ``cap`` in a cell are dropped from the bucketed view
and counted per cloud in ``overflow``, as in the reference; the conv then
leaves them out of every sum and gives a dropped sample 0.

All of it is integer and boolean tensor code that equals the JAX package's
exactly (the stable sort by cell, the rank within a cell, the trash slot),
and it runs on the tensors' device. Empty slots are marked by ``slot_mask``
alone: their ``positions`` are 0, where the reference parks them at the far
``SENTINEL`` coordinate for its kernels' distance test. Nothing here relies
on far coordinates. The kernels read features and write outputs in point
order through ``point_of_slot``, so the reference's ``bucketize`` /
``unbucketize`` (per-point values to slot order and back) have no use here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .grid import cell_coords


class BucketGrid(NamedTuple):
    """Bucketized view of a point set.

    Attributes:
      slot_of_point: ``(B, N)`` int32 — flat slot of each input point (points
        dropped by overflow or masked out map to the trash slot, the last).
      point_of_slot: ``(B, S + 1)`` int32 — input point of each slot (0 where
        empty, and at the trash slot). ``S = (R + 2)^3 * cap``.
      slot_mask: ``(B, S + 1)`` bool — the slot holds a kept point.
      positions: ``(B, S + 1, 3)`` — bucketed positions, 0 on empty slots.
      res: real cells per axis R. The padded axis is R + 2 (ghosts).
      cap: slots per cell (a multiple of 8).
      radius: the cell edge (the conv radius).
      overflow: ``(B,)`` int32 — points dropped by the cap.
      cell_count: ``(B, (R + 2)^3)`` int32 — kept points of each padded cell
        (they fill its first slots). Not in the reference: the port's kernels
        read it to skip empty slots.
    """

    slot_of_point: torch.Tensor
    point_of_slot: torch.Tensor
    slot_mask: torch.Tensor
    positions: torch.Tensor
    res: int
    cap: int
    radius: float
    overflow: torch.Tensor
    cell_count: torch.Tensor

    @property
    def padded_res(self) -> int:
        return self.res + 2

    @property
    def n_slots(self) -> int:  # excluding trash
        return self.padded_res**3 * self.cap


def res_for_radius(radius: float, max_res: int = 64) -> int:
    """Cells per axis, rounded up to even (``buckets.py:68-72``)."""
    r = min(max(1, math.ceil(1.0 / radius)), max_res)
    return r + (r % 2)


def padded_cell_id(coords: torch.Tensor, padded_res: int) -> torch.Tensor:
    """z-major flat id of a real cell coordinate, shifted into the ghost grid."""
    c = coords + 1
    return (c[..., 0] * padded_res + c[..., 1]) * padded_res + c[..., 2]


def build_buckets(points: torch.Tensor, mask: torch.Tensor, radius: float, cap: int, *,
                  max_res: int = 64) -> BucketGrid:
    """Bucketize ``(B, N, 3)`` unit-cube points at cell edge ``radius``
    (``buckets.py:82-138``)."""
    if cap % 8:
        raise ValueError(f"cap must be a multiple of 8, got {cap}")
    B, N, _ = points.shape
    dev = points.device
    R = res_for_radius(radius, max_res)
    Rp = R + 2
    n_slots = Rp**3 * cap
    trash = n_slots

    cid = padded_cell_id(cell_coords(points, float(radius), R), Rp)  # (B, N) int32
    # rank of each point within its cell, in ascending point order: stable
    # sort by cell (masked points last), then position - first position of
    # the cell in the sorted order
    key = torch.where(mask, cid, Rp**3)
    order = torch.argsort(key, dim=1, stable=True)
    sorted_key = torch.gather(key, 1, order).contiguous()
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank_sorted = (torch.arange(N, device=dev) - first).to(torch.int32)
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)

    ok = mask & (rank < cap)
    slot = torch.where(ok, cid * cap + rank, trash).to(torch.int32)
    overflow = (mask & (rank >= cap)).sum(dim=1, dtype=torch.int32)
    idx = slot.long()
    point_of_slot = torch.zeros((B, n_slots + 1), dtype=torch.int32, device=dev)
    point_of_slot.scatter_(1, idx, torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
                           .contiguous())
    point_of_slot[:, trash] = 0  # every dropped point lands here: no defined value
    slot_mask = torch.zeros((B, n_slots + 1), dtype=torch.bool, device=dev)
    slot_mask.scatter_(1, idx, ok)  # a kept point never maps to the trash slot
    positions = torch.gather(points, 1, point_of_slot.long()[..., None].expand(B, n_slots + 1, 3))
    positions = torch.where(slot_mask[..., None], positions, 0.0)
    cell_count = slot_mask[:, :-1].reshape(B, Rp**3, cap).sum(dim=-1, dtype=torch.int32)
    return BucketGrid(slot_of_point=slot, point_of_slot=point_of_slot, slot_mask=slot_mask,
                      positions=positions, res=R, cap=cap, radius=float(radius),
                      overflow=overflow, cell_count=cell_count)


def default_cap(n_points: int, radius: float, *, slack: float = 3.0) -> int:
    """Static cell capacity: the mean occupancy of a surface's cells times
    ``slack``, plus 8, rounded up to a multiple of 8 (``buckets.py:159-169``)."""
    R = res_for_radius(radius)
    surface_cells = max(1, 4 * R * R)
    mean_occ = n_points / surface_cells
    cap = int(math.ceil(mean_occ * slack)) + 8
    return min(max(8, (cap + 7) // 8 * 8), max(8, (n_points + 7) // 8 * 8))
