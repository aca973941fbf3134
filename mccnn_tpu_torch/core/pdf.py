"""KDE sample-density estimation (port of ``mccnn_tpu/core/pdf.py``).

``density[b, j] = (1 / (h^3 (2 pi)^1.5)) * sum_k exp(-|y_j - y_k|^2 / (2 h^2))``
over the in-radius points of ``y_j`` (itself included), ``h = kde_window * r``:
the UNNORMALIZED density (points per unit volume) that the Monte-Carlo
``1/pdf`` correction divides by. Masked points get 1.0.

Two paths, as in the reference: with a tile capacity ``tile_pairs`` the
exact z-order tile KDE (K7, ``ops/cuda/tile_conv.py::tile_kde``), the
big-scene path; else the dense KDE for N <= ``DENSE_KDE_MAX_N`` (K4,
``ops/cuda/density_kernel.py``). Each takes its kernel for a CUDA tensor and
its plain version for a CPU tensor. The reference's K-capacity path
(``pdf.py:107-144``, N > ``DENSE_KDE_MAX_N`` without a tile capacity) is not
ported yet and raises.
"""

from __future__ import annotations

import torch

from ..ops.cuda.density_kernel import kde_density_dense
from ..ops.cuda.tile_conv import tile_kde

DENSE_KDE_MAX_N = 8192  # mccnn_tpu/core/pdf.py:26: above it the reference truncates to K


def kde_density(
    points: torch.Tensor, mask: torch.Tensor, radius: float, *, kde_window: float = 0.25,
    tile_pairs: int | None = None, max_steps: int | None = None, with_overflow: bool = False,
):
    """Gaussian-KDE density ``(B, N)`` of each point within its own point set.

    ``tile_pairs`` routes to the tile KDE; ``with_overflow`` (tile path only)
    also returns its (B,) dropped step count."""
    if tile_pairs is not None:
        return tile_kde(points, mask, radius, max_pairs=tile_pairs, max_steps=max_steps,
                        kde_window=kde_window, with_overflow=with_overflow)
    N = points.shape[1]
    if N > DENSE_KDE_MAX_N:
        raise NotImplementedError(
            f"kde_density: N={N} > {DENSE_KDE_MAX_N} without a tile capacity takes the "
            "reference's K-capacity path, ported with core/neighbors.py (ROADMAP queue 1)"
        )
    return kde_density_dense(points, mask, radius, kde_window)
