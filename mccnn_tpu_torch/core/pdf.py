"""KDE sample-density estimation (port of ``mccnn_tpu/core/pdf.py``, dense path).

``density[b, j] = (1 / (h^3 (2 pi)^1.5)) * sum_k exp(-|y_j - y_k|^2 / (2 h^2))``
over the in-radius points of ``y_j`` (itself included), ``h = kde_window * r``:
the UNNORMALIZED density (points per unit volume) that the Monte-Carlo
``1/pdf`` correction divides by. Masked points get 1.0.

A CUDA tensor goes to the K4 kernel, a CPU tensor to its plain version
(``ops/cuda/density_kernel.py``). The reference's K-capacity path
(``pdf.py:107-144``, N > ``DENSE_KDE_MAX_N``) and its tile path come later.
"""

from __future__ import annotations

import torch

from ..ops.cuda.density_kernel import kde_density_dense

DENSE_KDE_MAX_N = 8192  # mccnn_tpu/core/pdf.py:26: above it the reference truncates to K


def kde_density(
    points: torch.Tensor, mask: torch.Tensor, radius: float, *, kde_window: float = 0.25
) -> torch.Tensor:
    """Gaussian-KDE density ``(B, N)`` of each point within its own point set."""
    N = points.shape[1]
    if N > DENSE_KDE_MAX_N:
        raise NotImplementedError(
            f"kde_density: N={N} > {DENSE_KDE_MAX_N} takes the reference's "
            "K-capacity path, ported with core/neighbors.py (ROADMAP queue 1)"
        )
    return kde_density_dense(points, mask, radius, kde_window)
