"""Spatial bookkeeping: AABBs, normalization, regular-grid cell ids.

Port of ``mccnn_tpu/core/grid.py``: the dense batched layout ``(B, N, 3)`` plus
a boolean validity mask, with per-point linear cell ids computed by plain
elementwise arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BIG = 1e9


def compute_aabb(points: torch.Tensor, mask: torch.Tensor):
    """Masked per-cloud axis-aligned bounding box, each ``(B, 3)``.

    Fully-masked clouds return a degenerate box at the origin.
    """
    m = mask[..., None]
    pmin = torch.where(m, points, _BIG).amin(dim=-2)
    pmax = torch.where(m, points, -_BIG).amax(dim=-2)
    any_valid = mask.any(dim=-1, keepdim=True)
    pmin = torch.where(any_valid, pmin, 0.0)
    pmax = torch.where(any_valid, pmax, 0.0)
    return pmin, pmax


def normalize_to_unit_cube(
    points: torch.Tensor, mask: torch.Tensor, *, scale_inv: bool = True,
    eps: float = 1e-12,
):
    """Map each cloud into ``[0, 1]^3``; returns ``(normalized, aabb_min, scale)``.

    ``scale_inv=True`` divides all axes by the largest extent (aspect kept);
    ``False`` normalizes each axis on its own.
    """
    aabb_min, aabb_max = compute_aabb(points, mask)
    extent = aabb_max - aabb_min
    if scale_inv:
        scale = extent.amax(dim=-1, keepdim=True).expand_as(extent)
    else:
        scale = extent
    scale = scale.clamp_min(eps)
    normalized = (points - aabb_min[..., None, :]) / scale[..., None, :]
    normalized = torch.where(mask[..., None], normalized, 0.0)
    return normalized, aabb_min, scale


def cell_coords(points: torch.Tensor, cell_size: float, grid_res: int) -> torch.Tensor:
    """Integer cell coordinates (floor, then clip into ``[0, grid_res)``).

    The divisor is a device tensor, not a Python scalar: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, which can move a
    point across a cell face and change the Poisson selection between the
    card and the CPU.
    """
    size = torch.full((), cell_size, dtype=points.dtype, device=points.device)
    c = torch.floor(points / size).to(torch.int32)
    return c.clamp(0, grid_res - 1)


def linear_cell_ids(coords: torch.Tensor, grid_res: int) -> torch.Tensor:
    """Row-major linear cell id from integer ``(..., 3)`` cell coords."""
    return (coords[..., 0] * grid_res + coords[..., 1]) * grid_res + coords[..., 2]


def cell_color27(coords: torch.Tensor) -> torch.Tensor:
    """27-coloring of grid cells: ``(cx%3, cy%3, cz%3)`` -> color in ``[0, 27)``."""
    m = coords % 3
    return (m[..., 0] * 3 + m[..., 1]) * 3 + m[..., 2]


def grid_res_for_radius(radius: float, cell_scale: float = 1.0, max_res: int = 512) -> int:
    """Grid resolution covering the unit cube with cells of edge ``radius * cell_scale``."""
    res = max(1, math.ceil(1.0 / (radius * cell_scale)))
    return min(res, max_res)


def row_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances between broadcastable rows ``a (..., 3)`` and ``b (..., 3)``.

    The port's one d2 expression, ``sq_a + sq_b - 2 * (xa*xb + ya*yb + za*zb)``,
    evaluated left to right with one rounding per elementwise op. The CUDA
    kernels evaluate the same expression with round-to-nearest intrinsics
    (no FMA contraction), so an in-radius test ``d2 <= r2`` gives the same
    bit on the card and here — a Poisson selection that differs in one point
    changes every later level.
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    sq_a = ax * ax + ay * ay + az * az
    sq_b = bx * bx + by * by + bz * bz
    return (sq_a + sq_b) - 2.0 * (ax * bx + ay * by + az * bz)


def pair_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``row_d2`` of every pair: ``(B, Na, Nb)`` between ``a (B, Na, 3)`` and
    ``b (B, Nb, 3)`` (the squared norms are formed once per point)."""
    return row_d2(a[:, :, None, :], b[:, None, :, :])


def radius_sq(radius: float) -> float:
    """``r^2`` rounded once: the Python float product cast to float32, as the
    JAX package's comparisons against a weak-typed ``radius * radius`` do."""
    return float(np.float32(float(radius) * float(radius)))
