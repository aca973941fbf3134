"""K4: dense Gaussian KDE — CUDA kernel wrapper and its plain PyTorch version.

Replaces ``mccnn_tpu/ops/pallas/density_kernel.py::_kde_kernel`` (reached
through ``kde_density_pallas`` from ``core/pdf.py::kde_density``). The kernel
is ``mccnn_tpu_torch/csrc/density_kernel.cu``: one thread per query, source
positions staged through shared memory in tiles; it is bound by the B*N^2
distance + exp evaluations, not by bytes (see the source's header).

``kde_density_dense`` picks by device: a CPU tensor runs
``kde_density_reference``, a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import math

import torch

from ...core.grid import pair_d2, radius_sq
from . import _build

# Launches of the CUDA kernel since the last reset (a plain integer, read and
# zeroed by chip_smoke.py to show the served path went through the kernel).
launches = 0


def _constants(radius: float, kde_window: float):
    h = kde_window * float(radius)
    norm = 1.0 / ((h**3) * (2.0 * math.pi) ** 1.5)
    return radius_sq(radius), -0.5 / (h * h), norm


def kde_density_reference(
    points: torch.Tensor, mask: torch.Tensor, radius: float, kde_window: float = 0.25
) -> torch.Tensor:
    """``norm * sum_{valid j, d2 <= r2} exp(-d2 / 2h^2)``; masked queries get 1.0."""
    r2, neg_half_inv_h2, norm = _constants(radius, kde_window)
    d2 = pair_d2(points, points).clamp_min(0.0)
    in_r = (d2 <= r2) & mask[:, None, :]
    kern = torch.where(in_r, torch.exp(d2 * neg_half_inv_h2), 0.0)
    return torch.where(mask, norm * kern.sum(dim=-1), 1.0)


def kde_density_cuda(
    points: torch.Tensor, mask: torch.Tensor, radius: float, kde_window: float = 0.25
) -> torch.Tensor:
    """Launch K4 on CUDA tensors ``points (B, N, 3) f32``, ``mask (B, N) bool``."""
    global launches
    _build.require_cuda("kde_density_cuda", points, mask)
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("kde_density_cuda: points must be float32 and mask bool")
    B, N, _ = points.shape
    r2, neg_half_inv_h2, norm = _constants(radius, kde_window)
    out = torch.empty((B, N), dtype=torch.float32, device=points.device)
    if B * N == 0:
        return out
    lib = _build.library()
    err = lib.kde_density_launch(
        _build.ptr(points), _build.ptr(mask), B, N, r2, neg_half_inv_h2, norm,
        _build.ptr(out), _build.stream_of(points),
    )
    _build.check(err, "kde_density_kernel")
    launches += 1
    return out


def kde_density_dense(
    points: torch.Tensor, mask: torch.Tensor, radius: float, kde_window: float = 0.25
) -> torch.Tensor:
    """CPU tensor -> plain version; CUDA tensor -> K4."""
    if points.device.type == "cpu":
        return kde_density_reference(points, mask, radius, kde_window)
    return kde_density_cuda(points.contiguous(), mask.contiguous(), radius, kde_window)
