"""Batched gather helpers shared by the core ops (port of ``mccnn_tpu/core/gather.py``).

The reference's ``onehot_gather`` works around slow row gathers on the TPU;
on the GPU ``torch.gather`` is the direct form, so it has no counterpart.
"""

from __future__ import annotations

import torch


def batched_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values: (B, N, *F); idx: (B, *I) int -> (B, *I, *F)."""
    B = values.shape[0]
    feat = values.shape[2:]
    flat_idx = idx.reshape(B, -1).long()
    gidx = flat_idx.reshape(flat_idx.shape + (1,) * len(feat)).expand(
        flat_idx.shape + feat
    )
    out = torch.gather(values, 1, gidx)
    return out.reshape(idx.shape + feat)


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values: (B, N, C), idx: (B, S) -> (B, S, C)."""
    return batched_gather(values, idx)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int, eps: float = 1e-8) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum(dim=axis) / (m.sum(dim=axis)).clamp_min(eps)
