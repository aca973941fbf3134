"""Fixed-radius neighbour search with a fixed capacity (port of
``mccnn_tpu/core/neighbors.py:34-145``).

Each query gets a dense ``(B, M, K)`` index tensor of its K nearest in-radius
sources, a mask and the true in-radius count. The search is a chunked dense
distance computation, as in the reference, which is plain ``jnp`` code there
and plain PyTorch here on either device. d2 is ``core/grid.py::pair_d2``'s
elementwise expression (one rounding per op), not the reference's HIGHEST
matmul: the card and the CPU then decide every in-radius test alike, and the
port agrees with the JAX package on inputs with no pair at the boundary
(``tests/port/parity_utils.py``). Sources at an equal distance (duplicate
points are common in resampled blocks) are taken in ascending index, as
``lax.top_k`` takes them: the selection is a top-k over one integer key per
pair, the bits of d2 (a non-negative float orders as its bit pattern) above
the source index, so it is the same on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .grid import pair_d2, radius_sq

_CHUNK_BUDGET = 2**22  # distances per cloud and chunk (neighbors.py:117-119)


class Neighborhood(NamedTuple):
    """Padded fixed-capacity neighbourhood of M queries among N sources.

    Attributes:
      idx: ``(B, M, K)`` int64 source indices; arbitrary where ``mask`` is
        False (within ``[0, N)``).
      mask: ``(B, M, K)`` bool — the entry holds a real neighbour.
      count: ``(B, M)`` int32 — the true in-radius count (may exceed K).
      radius: the search radius.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    radius: float


def radius_neighbors(queries: torch.Tensor, q_mask: torch.Tensor, sources: torch.Tensor,
                     s_mask: torch.Tensor, radius: float, k: int, *,
                     query_chunk: int | None = None) -> Neighborhood:
    """For each query, up to ``k`` nearest sources with ``d2 <= r2``; a point
    in both sets is its own neighbour. Queries run in chunks of
    ``query_chunk`` (default: all when ``M * N <= 2**22``, else ``2**22 //
    N``) to bound the distance matrix."""
    B, M, _ = queries.shape
    N = sources.shape[1]
    r2 = radius_sq(radius)
    if query_chunk is None:
        query_chunk = M if M * N <= _CHUNK_BUDGET else max(1, _CHUNK_BUDGET // N)
    k_eff = min(k, N)
    shift = max(1, (N - 1).bit_length())
    invalid = torch.iinfo(torch.int64).max
    src_index = torch.arange(N, device=sources.device)
    idx, nmask, count = [], [], []
    for i0 in range(0, M, query_chunk):
        q = queries[:, i0:i0 + query_chunk]
        d2 = pair_d2(q, sources)
        d2 = torch.where(d2 > 0.0, d2, 0.0)  # the reference's max(d2, 0), and never -0.0
        valid = (d2 <= r2) & s_mask[:, None, :] & q_mask[:, i0:i0 + query_chunk, None]
        count.append(valid.sum(dim=-1, dtype=torch.int32))
        key = (d2.view(torch.int32).long() << shift) | src_index
        key = torch.where(valid, key, invalid)
        top, top_key_idx = torch.topk(key, k_eff, dim=-1, largest=False)
        idx.append(top_key_idx)
        nmask.append(top < invalid)
    idx, nmask, count = torch.cat(idx, 1), torch.cat(nmask, 1), torch.cat(count, 1)
    if k_eff < k:
        pad = (0, k - k_eff)
        idx, nmask = torch.nn.functional.pad(idx, pad), torch.nn.functional.pad(nmask, pad)
    return Neighborhood(idx=idx, mask=nmask, count=count, radius=float(radius))


def self_neighbors(points: torch.Tensor, mask: torch.Tensor, radius: float,
                   k: int) -> Neighborhood:
    """Neighbourhood of a point set within itself (the sampler's)."""
    return radius_neighbors(points, mask, points, mask, radius, k)
