"""K3: the 27-colour Poisson-disk sweep — CUDA kernel wrapper and plain version.

Replaces ``mccnn_tpu/ops/pallas/poisson_kernel.py::_sweep_kernel`` (the
default v1, reached through ``poisson_sweep_pallas`` from
``core/sampling.py::poisson_disk``). The kernel is
``mccnn_tpu_torch/csrc/poisson_kernel.cu``: one block per cloud, the cloud's
whole state in shared memory, 27 colour steps separated by barriers. It is
bound by the latency of that dependent chain, not by bytes or arithmetic (see
the source's header). Its limit is ``MAX_N = 4096`` points per cloud.

The kernel and ``poisson_sweep_reference`` form d2 with the same explicit
expression (``core/grid.py::pair_d2``), so their selections are bit-equal.
"""

from __future__ import annotations

import torch

from ...core.grid import pair_d2, radius_sq
from . import _build

MAX_N = 4096  # shared-memory bound of the kernel (32 bytes a point)

# Launches of the CUDA kernel since the last reset (see density_kernel.py).
launches = 0


def poisson_sweep_reference(
    points: torch.Tensor,
    mask: torch.Tensor,
    cids: torch.Tensor,
    colors: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """(B, N) bool selection of the 27-colour maximal sweep (``_poisson_dense``)."""
    B, N, _ = points.shape
    adj = (pair_d2(points, points) <= radius_sq(radius)) & mask[:, None, :]
    idx = torch.arange(N, device=points.device)
    pred = (
        (cids[:, :, None] == cids[:, None, :])
        & (idx[None, None, :] < idx[None, :, None])
        & mask[:, None, :]
    )
    selected = torch.zeros((B, N), dtype=torch.bool, device=points.device)
    covered = torch.zeros_like(selected)
    for c in range(27):
        uncovered = mask & ~covered
        blocked = (pred & uncovered[:, None, :]).any(dim=-1)
        cand = uncovered & ~blocked & (colors == c)
        selected = selected | cand
        covered = covered | (adj & cand[:, None, :]).any(dim=-1)
    return selected & mask


def poisson_sweep_cuda(
    points: torch.Tensor,
    mask: torch.Tensor,
    cids: torch.Tensor,
    colors: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """Launch K3 on CUDA tensors: points (B, N, 3) f32, mask (B, N) bool,
    cids / colors (B, N) int32."""
    global launches
    _build.require_cuda("poisson_sweep_cuda", points, mask, cids, colors)
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("poisson_sweep_cuda: points must be float32 and mask bool")
    if cids.dtype != torch.int32 or colors.dtype != torch.int32:
        raise TypeError("poisson_sweep_cuda: cids and colors must be int32")
    B, N, _ = points.shape
    if N > MAX_N:
        raise NotImplementedError(
            f"poisson_sweep_cuda holds a cloud in shared memory (N <= {MAX_N}); "
            f"got N={N}. core.sampling.poisson_disk sends a larger level to the tile "
            "sampler (K8) when a tile capacity is set, else to the neighbour-list sampler."
        )
    sel = torch.empty((B, N), dtype=torch.bool, device=points.device)
    if B * N == 0:
        return sel
    lib = _build.library()
    err = lib.poisson_sweep_launch(
        _build.ptr(points), _build.ptr(mask), _build.ptr(cids), _build.ptr(colors),
        B, N, radius_sq(radius), _build.ptr(sel), _build.stream_of(points),
    )
    _build.check(err, "poisson_sweep_kernel")
    launches += 1
    return sel


def poisson_sweep(points, mask, cids, colors, radius) -> torch.Tensor:
    """CPU tensor -> plain version; CUDA tensor -> K3."""
    if points.device.type == "cpu":
        return poisson_sweep_reference(points, mask, cids, colors, radius)
    return poisson_sweep_cuda(
        points.contiguous(), mask.contiguous(), cids.contiguous(), colors.contiguous(), radius
    )
