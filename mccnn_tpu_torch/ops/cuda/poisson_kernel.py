"""K3 and its variants K3v2 / K3v3 / K3v4: the 27-colour Poisson-disk sweep —
CUDA kernel wrappers and plain versions.

K3 replaces ``mccnn_tpu/ops/pallas/poisson_kernel.py::_sweep_kernel`` (the
default v1, reached through ``poisson_sweep_pallas`` from
``core/sampling.py::poisson_disk``). Its kernel is
``mccnn_tpu_torch/csrc/poisson_kernel.cu``: one block per cloud, the cloud's
whole state in shared memory, sorted once by (colour, cell, index), then 27
colour steps separated by barriers. It is bound by the latency of that
dependent chain, not by bytes or arithmetic (see the source's header). Its
limit is ``MAX_N = 4096`` points per cloud.

The reference's three variants of the same selection, which
``MCCNN_POISSON_SWEEP`` switches on (``poisson_kernel.py:434-515``):

* ``v2`` (K3v2, ``_sweep_kernel_v2`` :105; ``csrc/poisson_sweep_v2.cu``):
  adjacency and same-cell-predecessor planes built once per cloud, then two
  binary matrix-vector products a colour step, ``blocked = pred^T unc`` and
  ``new_cov = adj cand``;
* ``v3`` (K3v3, ``_sweep_kernel_v3`` :293; ``csrc/poisson_sweep_v3.cu``):
  points sorted by (colour, cell, index), so each colour's candidates lie in
  one 128-aligned window of ``SWEEP_WINDOW`` points; a colour step tests
  candidates inside that window and coverage of every point against them;
* ``v4<SB>`` (K3v4, ``_sweep_kernel_v4`` :171; ``csrc/poisson_sweep_v4.cu``):
  SB clouds folded into one block, each colour step one phase for all of them
  (SB from the suffix, else ``MCCNN_POISSON_SB``, default 4).

The switch is read once, when this module is imported (``_SWEEP``, ``_SB``),
and consulted at call time (tests set the constants); the reference reads the
variable on each call (``:434``). ``poisson_sweep`` routes exactly as the
reference does, and ``routes`` counts the branch taken on either device: v2
always runs v2; v4 runs when ``SB <= 4`` and ``B % SB == 0``, else the
default sweep; any other value but ``v1`` runs v3 unless ``Np <= SWEEP_WINDOW``
(``Np``: N rounded up to 8) or a colour run of some cloud of the batch
overflows its window (the ``fits`` test, ``:466-473``), which take the
default sweep. The reference runs its Pallas sweep, and so the variants, only
for N <= 1024 (``core/sampling.py:133``): ``core/sampling.py`` passes
``variant="v1"`` above that.

Every kernel and plain version forms d2 with the same explicit expression
(``core/grid.py::pair_d2``), so their selections are bit-equal. Each kernel
has its own launch counter: ``launches`` (K3), ``launches_v2``,
``launches_v3``, ``launches_v4``.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import NamedTuple

import torch

from ...core.grid import pair_d2, radius_sq
from . import _build

MAX_N = 4096  # shared-memory bound of K3 (156 KB at 4096 points)
PROBE_STAMPS = 64  # clock64 stamps a block of K3's probe build (csrc kStamps)
VARIANT_MAX_N = 1024  # the variants' kernels, and the reference's MAX_N (:32)
SWEEP_WINDOW = 256  # the v3 window (:290)
_V3_ALIGN = 128  # v3 window starts are multiples of this (:470)

# MCCNN_POISSON_SWEEP and MCCNN_POISSON_SB (see the module docstring).
_SWEEP = os.environ.get("MCCNN_POISSON_SWEEP", "v1")
_SB = os.environ.get("MCCNN_POISSON_SB", "4")

# Launches of each CUDA kernel since the last reset (see density_kernel.py).
launches = 0
launches_v2 = 0
launches_v3 = 0
launches_v4 = 0
# Branches taken by ``poisson_sweep`` on either device: "v1" (the default
# sweep, K3), "v2", "v3", "v4".
routes: Counter = Counter()


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


def poisson_sweep_v2_reference(points, mask, cids, colors, radius) -> torch.Tensor:
    """The v2 formulation: 0/1 planes built once, two products a colour step
    (``_sweep_kernel_v2``): ``blocked = pred^T unc``, ``new_cov = adj cand``;
    a count above 0 is the OR."""
    B, N, _ = points.shape
    f32 = torch.float32
    adj = ((pair_d2(points, points) <= radius_sq(radius)) & mask[:, None, :]).to(f32)
    idx = torch.arange(N, device=points.device)
    # pred_t[j, i]: i is a valid same-cell predecessor of j (pred transposed)
    pred_t = ((cids[:, :, None] == cids[:, None, :]) & (idx[None, None, :] < idx[None, :, None])
              & mask[:, None, :]).to(f32)
    valid = mask.to(f32)
    sel = torch.zeros((B, N), dtype=f32, device=points.device)
    cov = torch.zeros_like(sel)
    for c in range(27):
        unc = valid * (1.0 - cov)
        blocked = torch.bmm(pred_t, unc[..., None])[..., 0] > 0.0
        cand = unc * (~blocked & (colors == c)).to(f32)
        sel = torch.maximum(sel, cand)
        cov = torch.maximum(cov, (torch.bmm(adj, cand[..., None])[..., 0] > 0.0).to(f32))
    return (sel > 0.0) & mask


class V3Layout(NamedTuple):
    """The colour-sorted layout of the v3 sweep (``poisson_kernel.py:453-473``).

    ``order (B, Np)``: the original index at each sorted position (>= N on
    the padding rows); ``starts (B, 27)`` int32: each colour's 128-aligned
    window start; ``fits``: every colour run of every cloud lies inside its
    window (one flag for the batch, as the reference's ``jnp.all``)."""

    order: torch.Tensor
    starts: torch.Tensor
    fits: torch.Tensor


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def v3_layout(mask: torch.Tensor, cids: torch.Tensor, colors: torch.Tensor) -> V3Layout:
    """Sort by (colour, cell, index): valid points by ``colour * 2^24 + cell``
    (stable), invalid and padding rows last; each colour's exclusive start,
    rounded down to 128 and clamped to ``Np - SWEEP_WINDOW``."""
    B, N = mask.shape
    Np = _round8(N)
    dev = mask.device
    cid = torch.where(mask, cids.long(), -1)
    col = colors.long()
    if Np != N:
        cid = torch.cat([cid, cid.new_full((B, Np - N), -1)], dim=1)
        col = torch.cat([col, col.new_full((B, Np - N), -2)], dim=1)
    valid = cid >= 0
    key = torch.where(valid, col * (1 << 24) + cid, 1 << 30)
    order = torch.argsort(key, dim=1, stable=True)
    counts = ((col[..., None] == torch.arange(27, device=dev)) & valid[..., None]).sum(1)
    starts_x = torch.cumsum(counts, dim=1) - counts
    aligned = torch.clamp_max(starts_x // _V3_ALIGN * _V3_ALIGN, Np - SWEEP_WINDOW)
    fits = (starts_x + counts <= aligned + SWEEP_WINDOW).all()
    return V3Layout(order=order, starts=aligned.to(torch.int32), fits=fits)


def _require_v3(layout: V3Layout, what: str) -> None:
    if layout.order.shape[1] <= SWEEP_WINDOW or not bool(layout.fits):
        raise ValueError(
            f"{what}: the batch has Np <= {SWEEP_WINDOW} points or a colour run that "
            "overflows its window; the reference runs the default sweep there "
            "(poisson_sweep routes it to K3)"
        )


def poisson_sweep_v3_reference(points, mask, cids, colors, radius,
                               layout: V3Layout | None = None) -> torch.Tensor:
    """The v3 formulation (``_sweep_kernel_v3`` and its wrapper): sort by
    (colour, cell, index); per colour, candidates and their same-cell
    predecessors only inside the colour's window of ``SWEEP_WINDOW`` sorted
    points, and coverage of every point against the window's candidates;
    then unsort. Needs a layout that fits (``poisson_sweep`` checks)."""
    layout = v3_layout(mask, cids, colors) if layout is None else layout
    _require_v3(layout, "poisson_sweep_v3_reference")
    B, N, _ = points.shape
    order = layout.order
    Np, W, dev = order.shape[1], SWEEP_WINDOW, points.device
    pad = Np - N
    pos = torch.cat([points, points.new_zeros((B, pad, 3))], dim=1)
    cid = torch.cat([torch.where(mask, cids.long(), -1), cids.new_full((B, pad), -1).long()], 1)
    col = torch.cat([colors.long(), colors.new_full((B, pad), -2).long()], dim=1)
    pos_s = torch.gather(pos, 1, order[..., None].expand(B, Np, 3))
    cid_s, col_s = torch.gather(cid, 1, order), torch.gather(col, 1, order)
    r2 = radius_sq(radius)
    w = torch.arange(W, device=dev)
    earlier = w[:, None] < w[None, :]  # [i, j]: window slot i precedes slot j
    sel = torch.zeros((B, Np), dtype=torch.bool, device=dev)
    cov = torch.zeros_like(sel)
    for c in range(27):
        idx = layout.starts[:, c, None].long() + w  # (B, W) sorted positions
        cid_w = torch.gather(cid_s, 1, idx)
        unc_w = (cid_w >= 0) & ~torch.gather(cov, 1, idx)
        pred_w = (cid_w[:, :, None] == cid_w[:, None, :]) & earlier
        blocked = (pred_w & unc_w[:, :, None]).any(dim=1)
        cand = unc_w & ~blocked & (torch.gather(col_s, 1, idx) == c)
        sel.scatter_(1, idx, torch.gather(sel, 1, idx) | cand)
        pos_w = torch.gather(pos_s, 1, idx[..., None].expand(B, W, 3))
        cov |= ((pair_d2(pos_s, pos_w) <= r2) & cand[:, None, :]).any(dim=-1)
    out = torch.zeros_like(sel)
    out.scatter_(1, order, sel)
    return out[:, :N] & mask


def _require_fold(B: int, sb: int, what: str) -> None:
    if sb < 1 or B % sb:
        raise ValueError(f"{what}: B={B} clouds cannot be folded {sb} a block; the reference "
                         "runs the default sweep there (poisson_sweep routes it to K3)")


def poisson_sweep_v4_reference(points, mask, cids, colors, radius, sb: int = 4) -> torch.Tensor:
    """The v4 formulation (``_sweep_kernel_v4``): SB clouds folded into one
    set of SB * N points whose planes join only points of one cloud; each
    colour step updates the SB clouds at once. Needs ``B % sb == 0``."""
    B, N, _ = points.shape
    _require_fold(B, sb, "poisson_sweep_v4_reference")
    G, T, dev = B // sb, sb * N, points.device
    pts, msk = points.reshape(G, T, 3), mask.reshape(G, T)
    cid, col = cids.reshape(G, T), colors.reshape(G, T)
    f = torch.arange(T, device=dev)
    same_cloud = (f[:, None] // N) == (f[None, :] // N)
    adj = (pair_d2(pts, pts) <= radius_sq(radius)) & same_cloud & msk[:, None, :]
    pred = ((cid[:, :, None] == cid[:, None, :]) & same_cloud
            & (f[None, :] < f[:, None]) & msk[:, None, :])
    sel = torch.zeros((G, T), dtype=torch.bool, device=dev)
    cov = torch.zeros_like(sel)
    for c in range(27):
        unc = msk & ~cov
        cand = unc & ~(pred & unc[:, None, :]).any(dim=-1) & (col == c)
        sel |= cand
        cov |= (adj & cand[:, None, :]).any(dim=-1)
    return sel.reshape(B, N) & mask


def _check_inputs(name: str, points, mask, cids, colors, max_n: int) -> None:
    _build.require_cuda(name, points, mask, cids, colors)
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"{name}: points must be float32 and mask bool")
    if cids.dtype != torch.int32 or colors.dtype != torch.int32:
        raise TypeError(f"{name}: cids and colors must be int32")
    N = points.shape[1]
    if N > max_n:
        raise NotImplementedError(
            f"{name} holds a cloud in shared memory (N <= {max_n}); got N={N}. "
            "core.sampling.poisson_disk runs the variants only up to "
            f"{VARIANT_MAX_N} points, K3 up to {MAX_N}, and sends a larger level to the "
            "tile sampler (K8) when a tile capacity is set, else to the neighbour-list sampler."
        )


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
    _check_inputs("poisson_sweep_cuda", points, mask, cids, colors, MAX_N)
    B, N, _ = points.shape
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


def poisson_sweep_probe_cuda(points, mask, cids, colors, radius):
    """Launch K3's probe build: K3's selection and (B, PROBE_STAMPS) int64
    clock64 stamps a block (the phases' ends, ``csrc/poisson_kernel.cu``).
    Not counted: only ``tools.poisson_split`` calls it."""
    _check_inputs("poisson_sweep_probe_cuda", points, mask, cids, colors, MAX_N)
    B, N, _ = points.shape
    sel = torch.empty((B, N), dtype=torch.bool, device=points.device)
    stamps = torch.zeros((B, PROBE_STAMPS), dtype=torch.int64, device=points.device)
    lib = _build.library()
    err = lib.poisson_sweep_probe_launch(
        _build.ptr(points), _build.ptr(mask), _build.ptr(cids), _build.ptr(colors),
        B, N, radius_sq(radius), _build.ptr(sel), _build.ptr(stamps), _build.stream_of(points),
    )
    _build.check(err, "poisson_sweep_kernel (probe)")
    return sel, stamps


def poisson_sweep_v2_cuda(points, mask, cids, colors, radius) -> torch.Tensor:
    """Launch K3v2 (the two bit-matrix products a colour step). Its
    predecessor bit plane, (B, ceil(N/32), N) words, lives in device memory;
    the adjacency plane in shared memory."""
    global launches_v2
    _check_inputs("poisson_sweep_v2_cuda", points, mask, cids, colors, VARIANT_MAX_N)
    B, N, _ = points.shape
    sel = torch.empty((B, N), dtype=torch.bool, device=points.device)
    if B * N == 0:
        return sel
    words = -(-N // 32)
    pred_bits = torch.empty((B, words, N), dtype=torch.int32, device=points.device)
    lib = _build.library()
    err = lib.poisson_sweep_v2_launch(
        _build.ptr(points), _build.ptr(mask), _build.ptr(cids), _build.ptr(colors),
        B, N, radius_sq(radius), _build.ptr(pred_bits), _build.ptr(sel),
        _build.stream_of(points),
    )
    _build.check(err, "poisson_sweep_v2_kernel")
    launches_v2 += 1
    return sel


def poisson_sweep_v3_cuda(points, mask, cids, colors, radius,
                          layout: V3Layout | None = None) -> torch.Tensor:
    """Launch K3v3 over the colour-sorted layout (``v3_layout``, which must
    fit): the kernel reads the points through ``order`` and writes the
    selection back in the original order."""
    global launches_v3
    _check_inputs("poisson_sweep_v3_cuda", points, mask, cids, colors, VARIANT_MAX_N)
    B, N, _ = points.shape
    sel = torch.empty((B, N), dtype=torch.bool, device=points.device)
    if B * N == 0:
        return sel
    layout = v3_layout(mask, cids, colors) if layout is None else layout
    _require_v3(layout, "poisson_sweep_v3_cuda")
    order = layout.order.to(torch.int32).contiguous()
    starts = layout.starts.contiguous()
    lib = _build.library()
    err = lib.poisson_sweep_v3_launch(
        _build.ptr(points), _build.ptr(mask), _build.ptr(cids), _build.ptr(colors),
        _build.ptr(order), _build.ptr(starts), B, N, order.shape[1], radius_sq(radius),
        _build.ptr(sel), _build.stream_of(points),
    )
    _build.check(err, "poisson_sweep_v3_kernel")
    launches_v3 += 1
    return sel


def poisson_sweep_v4_cuda(points, mask, cids, colors, radius, sb: int = 4) -> torch.Tensor:
    """Launch K3v4: ``sb`` clouds a block (``B % sb == 0``, ``sb <= 4``)."""
    global launches_v4
    _check_inputs("poisson_sweep_v4_cuda", points, mask, cids, colors, VARIANT_MAX_N)
    B, N, _ = points.shape
    _require_fold(B, sb, "poisson_sweep_v4_cuda")
    if sb > 4:
        raise NotImplementedError(f"poisson_sweep_v4_cuda folds at most 4 clouds; got {sb}")
    sel = torch.empty((B, N), dtype=torch.bool, device=points.device)
    if B * N == 0:
        return sel
    lib = _build.library()
    err = lib.poisson_sweep_v4_launch(
        _build.ptr(points), _build.ptr(mask), _build.ptr(cids), _build.ptr(colors),
        B, N, sb, radius_sq(radius), _build.ptr(sel), _build.stream_of(points),
    )
    _build.check(err, "poisson_sweep_v4_kernel")
    launches_v4 += 1
    return sel


def poisson_sweep(points, mask, cids, colors, radius, variant: str | None = None) -> torch.Tensor:
    """The sweep ``variant`` selects (default: the switch, ``_SWEEP``), routed
    as ``poisson_sweep_pallas`` routes it (module docstring); a CPU tensor
    runs the branch's plain version, a CUDA tensor its kernel."""
    B, N, _ = points.shape
    cpu = points.device.type == "cpu"
    if not cpu:
        points, mask, cids, colors = (t.contiguous() for t in (points, mask, cids, colors))
    args = (points, mask, cids, colors, radius)
    variant = _SWEEP if variant is None else variant
    if variant == "v2":
        routes["v2"] += 1
        return poisson_sweep_v2_reference(*args) if cpu else poisson_sweep_v2_cuda(*args)
    if variant.startswith("v4"):
        sb = int(variant[2:] or _SB)
        if sb <= 4 and B % sb == 0:
            routes["v4"] += 1
            return (poisson_sweep_v4_reference(*args, sb=sb) if cpu
                    else poisson_sweep_v4_cuda(*args, sb=sb))
        variant = "v1"  # the batch does not fold: the default sweep
    if variant != "v1" and _round8(N) > SWEEP_WINDOW:
        layout = v3_layout(mask, cids, colors)
        if bool(layout.fits):  # the reference's lax.cond, decided on the host
            routes["v3"] += 1
            return (poisson_sweep_v3_reference(*args, layout=layout) if cpu
                    else poisson_sweep_v3_cuda(*args, layout=layout))
    routes["v1"] += 1
    return poisson_sweep_reference(*args) if cpu else poisson_sweep_cuda(*args)
