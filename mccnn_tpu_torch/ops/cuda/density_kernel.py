"""K4: dense Gaussian KDE — CUDA kernel wrapper and its plain PyTorch version.

Replaces ``mccnn_tpu/ops/pallas/density_kernel.py::_kde_kernel`` (reached
through ``kde_density_pallas`` from ``core/pdf.py::kde_density``). The kernels
are in ``mccnn_tpu_torch/csrc/density_kernel.cu``, two bodies of one function
(see the source's header): the all-pairs body, one thread per query over every
source, and the culled body, which sorts each cloud by cell (one block a
cloud), keeps a box per group of 32 sorted sources and sweeps a warp of 32
sorted queries over only the groups within the radius of its box.
``pick_body`` chooses by shape.

``kde_density_dense`` picks by device: a CPU tensor runs
``kde_density_reference``, a CUDA tensor launches a kernel body.
"""

from __future__ import annotations

import math

import torch

from ...core.grid import pair_d2, radius_sq
from . import _build

# Launches of the CUDA kernel since the last reset (a plain integer, read and
# zeroed by chip_smoke.py to show the served path went through the kernel).
launches = 0

# The culled body from this many points a cloud up to the most its layout
# block sorts; the card times that set the lower end are in the header of
# csrc/density_kernel.cu.
CULL_MIN_N, CULL_MAX_N = 1024, 8192


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


def pick_body(n_points: int) -> str:
    """The body K4 runs on clouds of ``n_points``: "culled" or "all_pairs"."""
    return "culled" if CULL_MIN_N <= n_points <= CULL_MAX_N else "all_pairs"


def _launch(points: torch.Tensor, mask: torch.Tensor, r2: float, neg_half_inv_h2: float,
            norm: float, body: str) -> torch.Tensor:
    """``norm * sum_{valid j, d2 <= r2} exp(d2 * neg_half_inv_h2)`` (1.0 on
    masked queries) through ``body``; with ``neg_half_inv_h2 = 0`` and ``norm =
    1`` each valid query's in-radius valid source count, exactly."""
    global launches
    B, N, _ = points.shape
    out = torch.empty((B, N), dtype=torch.float32, device=points.device)
    if B * N == 0:
        return out
    lib = _build.library()
    stream = _build.stream_of(points)
    if body == "all_pairs":
        err = lib.kde_density_launch(_build.ptr(points), _build.ptr(mask), B, N, r2,
                                     neg_half_inv_h2, norm, _build.ptr(out), stream)
    elif body == "culled":
        nbytes = lib.kde_culled_scratch_bytes(B, N)
        if nbytes < 0:
            raise OverflowError(f"kde_density_cuda: the culled body's scratch passes 2**31 bytes "
                                f"at B={B}, N={N}")
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=points.device)
        err = lib.kde_density_culled_launch(
            _build.ptr(points), _build.ptr(mask), B, N, r2, neg_half_inv_h2, norm,
            _build.ptr(scratch), _build.ptr(out), stream)
    else:
        raise ValueError(f"kde_density_cuda: body {body!r} is neither 'culled' nor 'all_pairs'")
    _build.check(err, f"kde_density ({body})")
    launches += 1
    return out


def kde_density_cuda(
    points: torch.Tensor, mask: torch.Tensor, radius: float, kde_window: float = 0.25,
    body: str | None = None,
) -> torch.Tensor:
    """Launch K4 on CUDA tensors ``points (B, N, 3) f32``, ``mask (B, N) bool``;
    ``body`` overrides ``pick_body``."""
    _build.require_cuda("kde_density_cuda", points, mask)
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("kde_density_cuda: points must be float32 and mask bool")
    r2, neg_half_inv_h2, norm = _constants(radius, kde_window)
    return _launch(points, mask, r2, neg_half_inv_h2, norm, body or pick_body(points.shape[1]))


def kde_density_dense(
    points: torch.Tensor, mask: torch.Tensor, radius: float, kde_window: float = 0.25
) -> torch.Tensor:
    """CPU tensor -> plain version; CUDA tensor -> K4."""
    if points.device.type == "cpu":
        return kde_density_reference(points, mask, radius, kde_window)
    return kde_density_cuda(points.contiguous(), mask.contiguous(), radius, kde_window)
