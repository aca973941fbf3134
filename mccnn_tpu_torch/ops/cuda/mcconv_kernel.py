"""K9 and K10: the cell-bucket Monte-Carlo convolution, forward and backward
(port of ``mccnn_tpu/ops/pallas/mcconv_kernel.py``).

K9 replaces ``_fwd_kernel`` (``mcconv_kernel.py:293``, called at ``:584``
through ``_fwd_call`` from ``bucket_mc_conv``); K10 replaces ``_bwd_kernel``
(``:366``, called at ``:662`` through ``_bwd_call`` from the ``custom_vjp``
at ``:688-763``). ``bucket_mc_conv`` has the reference's semantics
(``:814-930``): both point sets live in cell-bucket layouts at cell edge =
radius (``core/buckets.py``), and for every kept sample every kept source in
the 27 cells around the sample's cell with ``d2 <= r2`` contributes. A point
dropped by a cell's overflow is in no sum, a dropped sample gets 0, and so
does every masked sample.

The kernels (``csrc/bucket_conv.cu``, ``csrc/bucket_conv_bwd.cu``) give K9
a block for each 32 kept samples of a (cloud, sample cell) and K10 a block for
each 32 kept sources of a (cloud, source cell), over all their channels; a
block over an empty cell exits at once. K9 runs K5's body
(``csrc/list_fwd.cuh``) and K10 K6's (``csrc/list_bwd.cuh``): one d2 test a
window pair into each owner's list of in-radius points, then the contraction
over the lists. They read
positions from the layouts (slot order) and features, outputs and the
cotangent in point order through ``point_of_slot``: every output row has one
writer, and no (B, slots, C) tensor exists. K9 forms ``G[i,h,c] = sum_j
a_h(i,j) f~[j,c]`` as K1 and K5 do, projecting it in its epilogue
(depthwise) or through K1's projection GEMM (full). K10 forms K6's
quantities (X, d_f~, and per-block partials of the parameter gradients,
summed in a fixed order by K2's reduction kernel): no float atomics, two
calls are bit-identical. Everything is fp32 (the TPU kernels hold features in
bf16).

Each kernel has a plain PyTorch version that walks the same 27-cell windows
of the same layouts and keeps only ``slot_mask`` slots, so it drops what the
kernel drops. ``BucketMCConvFunction`` runs K9 / K10 on CUDA tensors and the
plain versions on CPU tensors. Positions and the layouts get no gradient
(positions are data, as the reference's ``_core_bwd`` returns zeros for
them); ``features / pdf`` stays outside the Function, so autograd carries
``d_f~`` on to the features and the pdf.

K9a and K10a are the same kernels over a list of bricks: the reference's
``max_active_bricks`` (``_fwd_kernel`` / ``_bwd_kernel`` over a prefetched
list of occupied bricks, calls ``:570`` and ``:644``), which ``MCConv`` never
passes. A brick is a 2x2xBZ block of cells (``pick_bz``); ``_brick_activity``
lists a layout's bricks occupied first, and K9a visits the sample cells of
the first NBA bricks of the sample layout, K10a the source cells of the
first NBA bricks of the source layout. The rest keep the zeros they were
allocated with: a sample there gets 0, and so does the feature gradient of
a source there, whose pairs are also missing from the parameter gradients.
That backward is not the gradient of its forward (which reads every source
of a visited sample's window): the reference's semantics, copied.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ...core.buckets import BucketGrid
from ...core.grid import radius_sq, row_d2
from ...core.mcconv import MCConvParams
from . import _build, dense_conv
from .tile_conv import source_grads

# Launches of K9, K10, K9a and K10a since the last reset (see density_kernel.py).
launches = 0
backward_launches = 0
launches_active = 0
backward_launches_active = 0

_OFFSETS = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dz in (-1, 0, 1)])
_PAIR_BUDGET = 2**25  # elements of the largest per-chunk tensor of the plain versions
BWD_OWNERS = 32  # kept slots of a cell a K10 block owns (csrc/bucket_conv_bwd.cu kOwners)
BRICK_SLOTS = 128  # a brick holds at least this many slots where R allows (the TPU's lane width)


def kept_points(grid: BucketGrid) -> torch.Tensor:
    """(B, N) bool: the point holds a slot of the layout (not masked, not dropped)."""
    return grid.slot_of_point < grid.n_slots


def _check_grids(sample_grid: BucketGrid, source_grid: BucketGrid) -> None:
    if sample_grid.radius != source_grid.radius or sample_grid.res != source_grid.res:
        raise ValueError("bucket conv: the two layouts need one cell edge and resolution, got "
                         f"r={sample_grid.radius}/{source_grid.radius}, "
                         f"R={sample_grid.res}/{source_grid.res}")


def _window_slots(sample_grid: BucketGrid, source_grid: BucketGrid, slot: torch.Tensor):
    """For sample slots ``(B, m)``: the source slots of the 27 cells around
    each sample's cell ``(B, m, 27 * cap_p)`` and whether the sample is kept."""
    Rp = sample_grid.padded_res
    kept = slot < sample_grid.n_slots
    first_real = (Rp + 1) * Rp + 1  # any real cell: its window stays in the grid
    cell = torch.where(kept, slot // sample_grid.cap, first_real)
    off = _OFFSETS.to(slot.device)
    off = (off[:, 0] * Rp + off[:, 1]) * Rp + off[:, 2]
    cap = source_grid.cap
    cand = (cell[..., None] + off)[..., None] * cap + torch.arange(cap, device=slot.device)
    return cand.reshape(*slot.shape, 27 * cap), kept


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, S, *F)`` at ``idx (B, *I)`` -> ``(B, *I, *F)``."""
    B = x.shape[0]
    feat = x.shape[2:]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(x, 1, flat.reshape(B, -1, *([1] * len(feat))).expand(B, -1, *feat))
    return out.reshape(*idx.shape, *feat)


def _walk_windows(sample_grid: BucketGrid, source_grid: BucketGrid, wf: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor):
    """Yield, per chunk of sample points ``[m0, m1)``: ``(m0, m1, kept (B, m),
    pidx (B, m, K) source point of each candidate, f (B, m, K, C), inr (B, m,
    K), off (B, m, K, 3), pre (B, m, K, H))`` over the candidates of the
    27-cell windows (K = 27 * cap_p). ``pre`` is rounded as the kernels'
    ``mc_preact`` forms it, so a pair's ReLU step falls as on the card."""
    B, M = sample_grid.slot_of_point.shape
    C = wf.shape[-1]
    K = 27 * source_grid.cap
    r2 = radius_sq(source_grid.radius)
    r_dev = torch.full((), source_grid.radius, dtype=wf.dtype, device=wf.device)
    chunk = max(1, _PAIR_BUDGET // (B * K * max(C, w1.shape[1] + 4)))
    for m0 in range(0, M, chunk):
        slot = sample_grid.slot_of_point[:, m0:m0 + chunk].long()
        cand, kept = _window_slots(sample_grid, source_grid, slot)
        q = _gather_rows(sample_grid.positions, slot)  # (B, m, 3)
        p = _gather_rows(source_grid.positions, cand)  # (B, m, K, 3)
        pv = _gather_rows(source_grid.slot_mask, cand) & kept[..., None]
        pidx = _gather_rows(source_grid.point_of_slot, cand)
        inr = (row_d2(q[:, :, None, :], p) <= r2) & pv
        off = (p - q[:, :, None, :]) / r_dev
        pre = dense_conv._kernel_preact(off, w1, b1)
        yield m0, m0 + slot.shape[1], kept, pidx, _gather_rows(wf, pidx), inr, off, pre


def _activations(pre: torch.Tensor, inr: torch.Tensor) -> torch.Tensor:
    """``[relu(pre_h)..., 1]`` on in-radius pairs, 0 elsewhere (B, m, K, H+1)."""
    return torch.cat([torch.relu(pre), torch.ones_like(pre[..., :1])], dim=-1) * inr[..., None]


def bucket_conv_reference(params: MCConvParams, sample_grid: BucketGrid,
                          source_grid: BucketGrid, wf: torch.Tensor, *, c_out=None,
                          mean_normalize=False):
    """Plain version of K9: ``(out (B, M, C | c_out), cnt (B, M))`` in sample
    point order, 0 for a sample the layout does not keep. ``wf (B, N, C)`` is
    ``features / pdf`` in source point order."""
    _check_grids(sample_grid, source_grid)
    B, M = sample_grid.slot_of_point.shape
    H = params.w1.shape[1]
    C = wf.shape[-1]
    G = wf.new_zeros((B, M, H + 1, C))
    cnt = wf.new_zeros((B, M))
    for m0, m1, _, _, f, inr, _, pre in _walk_windows(sample_grid, source_grid, wf, params.w1,
                                                      params.b1):
        G[:, m0:m1] = torch.einsum("bmkh,bmkc->bmhc", _activations(pre, inr), f)
        cnt[:, m0:m1] = inr.sum(dim=-1).to(wf.dtype)
    kept = kept_points(sample_grid)
    out = dense_conv.project_reference(params, G, cnt, kept, c_out, mean_normalize)
    return out, cnt


def _cotangent_dG(params: MCConvParams, t: torch.Tensor, C: int, c_out):
    """``dG[i,h,c] = sum_o t[i,o] Wcat[h,c,o]`` (B, M, H+1, C), ``Wcat = [W2; b2]``."""
    w2, b2 = params.w2, params.b2
    H = params.w1.shape[1]
    if c_out is None:
        return torch.cat([t[:, :, None, :] * w2, (t * b2)[:, :, None, :]], dim=2)
    wcat = torch.cat([w2.reshape(H * C, c_out), b2.reshape(C, c_out)])
    B, M, _ = t.shape
    return (t.reshape(B * M, c_out) @ wcat.T).reshape(B, M, H + 1, C)


def bucket_conv_backward_reference(params: MCConvParams, sample_grid: BucketGrid,
                                   source_grid: BucketGrid, wf: torch.Tensor, cnt: torch.Tensor,
                                   dout: torch.Tensor, *, c_out=None, mean_normalize=False):
    """Plain version of K10: ``(d_wf (B, N, C), dw1 (3, H), db1 (H,), dw2,
    db2)`` in the shapes of ``MCConvParams``, from the forward's inputs, its
    count and ``dout (B, M, C | c_out)``. Per pair it forms what K10 forms:
    d_wf gets ``sum_h a_h dG[i,h,:]``, and ``dpre_h = [pre_h > 0] [in radius]
    dG[i,h,:] . f~[j,:]`` whose sums against the offset give dW1 and db1;
    ``[dW2; db2] = sum_i G[i] t[i]`` (K10 sums the same products source by
    source, from X)."""
    _check_grids(sample_grid, source_grid)
    w1, b1, w2, b2 = params
    H = w1.shape[1]
    B, N, C = wf.shape
    kept = kept_points(sample_grid)
    t = dout * dense_conv._scale(cnt, kept, mean_normalize)[..., None]
    dG = _cotangent_dG(params, t, C, c_out)
    d_wf = wf.new_zeros((B * N, C))
    dw1, db1 = wf.new_zeros((3, H)), wf.new_zeros((H,))
    dwcat = wf.new_zeros((H + 1, C) if c_out is None else ((H + 1) * C, c_out))
    rows = (torch.arange(B, device=wf.device) * N)[:, None, None]
    for m0, m1, _, pidx, f, inr, off, pre in _walk_windows(sample_grid, source_grid, wf, w1, b1):
        a = _activations(pre, inr)
        g, tc = dG[:, m0:m1], t[:, m0:m1]
        d_wf.index_add_(0, (rows + pidx).reshape(-1),
                        torch.einsum("bmkh,bmhc->bmkc", a, g).reshape(-1, C))
        Gc = torch.einsum("bmkh,bmkc->bmhc", a, f)
        if c_out is None:
            dwcat += (Gc * tc[:, :, None, :]).sum(dim=(0, 1))
        else:
            dwcat += Gc.reshape(-1, (H + 1) * C).T @ tc.reshape(-1, c_out)
        dpre = torch.einsum("bmhc,bmkc->bmkh", g[:, :, :H], f)
        dpre = torch.where((pre > 0) & inr[..., None], dpre, 0.0)  # the step at pre == 0 is 0
        dw1 += torch.einsum("bmkh,bmkd->dh", dpre, off)
        db1 += dpre.sum(dim=(0, 1, 2))
    dw2, db2 = dense_conv._split_wcat(dwcat, H, C, c_out, w2, b2)
    return d_wf.reshape(B, N, C), dw1, db1, dw2, db2


# ------------------------------------------------------------------ active bricks (K9a, K10a)


class BrickList(NamedTuple):
    """A layout's bricks in visiting order: ``ids (B, NBA)`` int32, the
    bricks K9a / K10a visit, and ``ranks (B, n_bricks)`` int32, each brick's
    place in the full order (visited iff < NBA)."""

    ids: torch.Tensor
    ranks: torch.Tensor

    @property
    def nba(self) -> int:
        return self.ids.shape[1]


class ActiveBricks(NamedTuple):
    """What K9a visits (``smp``, bricks of the sample layout) and K10a
    (``src``, of the source layout), bricks of 2 x 2 x ``bz`` cells."""

    smp: BrickList
    src: BrickList
    bz: int


def pick_bz(R: int, cap: int) -> int:
    """z depth of a brick (``mcconv_kernel.py:770``): the smallest divisor of
    R whose 2 x 2 x BZ brick holds at least 128 slots of ``cap``."""
    for bz in range(1, R + 1):
        if R % bz == 0 and 4 * bz * cap >= BRICK_SLOTS:
            return bz
    return R


def n_bricks(R: int, bz: int) -> int:
    return (R // 2) ** 2 * (R // bz)


@functools.lru_cache(maxsize=None)
def brick_cells(R: int, bz: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_bricks, 4 * bz) padded cell ids of each brick, in the order of the
    reference's block-major layout (``_block_perm``, ``mcconv_kernel.py:119-141``):
    bricks x-major with z fastest, the cells of a brick x-major with z
    fastest. Row ``k`` times cap plus the slot gives that layout's rows. One
    copy a device, made once."""
    if R % 2 or R % bz:
        raise ValueError(f"bricks of 2 x 2 x {bz} cells do not tile R = {R}")
    nb, nbz, Rp = R // 2, R // bz, R + 2
    bx, by, bk, dx, dy, dz = torch.meshgrid(*(torch.arange(n) for n in (nb, nb, nbz, 2, 2, bz)),
                                            indexing="ij")
    cells = ((2 * bx + dx + 1) * Rp + (2 * by + dy + 1)) * Rp + (bz * bk + dz + 1)
    return cells.reshape(nb * nb * nbz, 4 * bz).to(device)


@functools.lru_cache(maxsize=None)
def cell_brick(R: int, bz: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(Rp^3 + 1,) the brick of each padded cell (the inverse of
    ``brick_cells``, as ``_inv_block_perm``, ``:144-153``, inverts the
    reference's permutation); a ghost cell and the entry past the end (the
    trash slot's cell) hold n_bricks."""
    cells = brick_cells(R, bz)
    out = torch.full(((R + 2) ** 3 + 1,), len(cells), dtype=torch.int64)
    out[cells] = torch.arange(len(cells))[:, None]
    return out.to(device)


def brick_occupancy(grid: BucketGrid, bz: int) -> torch.Tensor:
    """(B, n_bricks) bool: the brick holds a point of the layout."""
    cells = brick_cells(grid.res, bz, grid.cell_count.device)
    return (grid.cell_count[:, cells] > 0).any(dim=-1)


def count_active_bricks(grid: BucketGrid) -> torch.Tensor:
    """(B,) occupied bricks a cloud at BZ = ``pick_bz(R, cap)``
    (``mcconv_kernel.py:783``): the least lossless ``max_active_bricks`` of
    a conv whose two layouts are ``grid``."""
    return brick_occupancy(grid, pick_bz(grid.res, grid.cap)).sum(dim=-1)


def _brick_activity(grid: BucketGrid, bz: int, nba: int) -> BrickList:
    """A layout's bricks occupied first in ascending id, then the empty ones
    (a stable sort, ``mcconv_kernel.py:795``); the first ``nba`` are
    visited. On the layout's device: no value reaches the host."""
    occ = brick_occupancy(grid, bz)
    order = torch.argsort((~occ).to(torch.uint8), dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    return BrickList(order[:, :nba].to(torch.int32).contiguous(), ranks.to(torch.int32))


def active_bricks(sample_grid: BucketGrid, source_grid: BucketGrid,
                  max_active_bricks: int | None) -> ActiveBricks | None:
    """The bricks of ``bucket_mc_conv(..., max_active_bricks=)``, or None for
    the dense sweep (K9 / K10): the rule of ``mcconv_kernel.py:872-878``,
    BZ from the smaller cap, and no list when NBA covers every brick."""
    if max_active_bricks is None:
        return None
    if max_active_bricks < 1:
        raise ValueError(f"max_active_bricks must be at least 1, got {max_active_bricks}")
    _check_grids(sample_grid, source_grid)
    bz = pick_bz(source_grid.res, min(sample_grid.cap, source_grid.cap))
    if max_active_bricks >= n_bricks(source_grid.res, bz):
        return None
    return ActiveBricks(_brick_activity(sample_grid, bz, max_active_bricks),
                        _brick_activity(source_grid, bz, max_active_bricks), bz)


def _visited_cells(grid: BucketGrid, bricks: BrickList, bz: int) -> torch.Tensor:
    """(B, Rp^3 + 1) bool: the padded cell lies in a visited brick."""
    B = bricks.ranks.shape[0]
    ranks = torch.cat([bricks.ranks, bricks.ranks.new_full((B, 1), bricks.nba)], dim=1)
    return ranks[:, cell_brick(grid.res, bz, ranks.device)] < bricks.nba


def visited_points(grid: BucketGrid, bricks: BrickList, bz: int) -> torch.Tensor:
    """(B, N) bool: the point holds a slot of the layout in a visited brick."""
    cells = _visited_cells(grid, bricks, bz)
    return torch.gather(cells, 1, (grid.slot_of_point // grid.cap).long())


def _visited_samples(grid: BucketGrid, bricks: BrickList, bz: int) -> BucketGrid:
    """The layout with the points of unvisited bricks sent to the trash slot."""
    keep = visited_points(grid, bricks, bz)
    return grid._replace(slot_of_point=torch.where(keep, grid.slot_of_point, grid.n_slots))


def _visited_sources(grid: BucketGrid, bricks: BrickList, bz: int) -> BucketGrid:
    """The layout with the slots of unvisited bricks out of ``slot_mask``."""
    cells = _visited_cells(grid, bricks, bz)
    slots = torch.cat([cells[:, :-1].repeat_interleave(grid.cap, dim=1), cells[:, -1:]], dim=1)
    return grid._replace(slot_mask=grid.slot_mask & slots)


def bucket_conv_active_reference(params: MCConvParams, sample_grid: BucketGrid,
                                 source_grid: BucketGrid, wf: torch.Tensor, active: ActiveBricks,
                                 *, c_out=None, mean_normalize=False):
    """Plain version of K9a: K9's ``(out, cnt)`` at the samples of the
    visited sample bricks (``active.smp``), 0 at every other sample. The
    sources come from the whole layout, as the reference fetches each
    brick's window from it (``mcconv_kernel.py:212-236``)."""
    return bucket_conv_reference(params, _visited_samples(sample_grid, active.smp, active.bz),
                                 source_grid, wf, c_out=c_out, mean_normalize=mean_normalize)


def bucket_conv_backward_active_reference(params: MCConvParams, sample_grid: BucketGrid,
                                          source_grid: BucketGrid, wf: torch.Tensor,
                                          cnt: torch.Tensor, dout: torch.Tensor,
                                          active: ActiveBricks, *, c_out=None,
                                          mean_normalize=False):
    """Plain version of K10a: K10's gradients over the pairs of a visited
    sample and a source of a visited source brick (``active.src``). A source
    of another brick gets a feature gradient of 0 and its pairs are missing
    from the parameter gradients, though the forward read it: the
    reference's backward walks only the listed source bricks (``:905-908``).
    ``cnt`` is the forward's, 0 at unvisited samples."""
    return bucket_conv_backward_reference(
        params, _visited_samples(sample_grid, active.smp, active.bz),
        _visited_sources(source_grid, active.src, active.bz), wf, cnt, dout, c_out=c_out,
        mean_normalize=mean_normalize)


# ------------------------------------------------------------------ CUDA wrappers


def _layout_tensors(grid: BucketGrid):
    return tuple(x.contiguous() for x in (grid.positions, grid.point_of_slot, grid.cell_count))


def _kernel_inputs(what: str, params: MCConvParams, sample_grid: BucketGrid,
                   source_grid: BucketGrid, wf: torch.Tensor, *extra: torch.Tensor):
    _check_grids(sample_grid, source_grid)
    w1, b1, w2, b2 = (x.contiguous() for x in params)
    smp, src = _layout_tensors(sample_grid), _layout_tensors(source_grid)
    _build.require_cuda(what, *smp, *src, wf, w1, b1, w2, b2, *extra)
    if any(x.dtype != torch.float32 for x in (smp[0], src[0], wf, w1, b1, w2, b2, *extra)):
        raise TypeError(f"{what}: positions, features and params must be float32")
    H, C = w1.shape[1], wf.shape[-1]
    if H != dense_conv.HIDDEN or C > dense_conv.MAX_C:
        raise NotImplementedError(f"{what} is built for H={dense_conv.HIDDEN} and "
                                  f"C<={dense_conv.MAX_C}; got H={H}, C={C}")
    return (w1, b1, w2, b2), smp, src


def _active_ids(what: str, grid: BucketGrid, bricks: BrickList, bz: int, like: torch.Tensor):
    """The brick list's ids for a launch, checked: (B, NBA) int32 on ``like``'s device."""
    ids = bricks.ids
    _build.require_cuda(what, like, ids)
    B = grid.slot_of_point.shape[0]
    if ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[0] != B:
        raise TypeError(f"{what}: brick ids must be (B={B}, NBA) int32, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if not 1 <= bricks.nba <= n_bricks(grid.res, bz):
        raise ValueError(f"{what}: NBA={bricks.nba} outside 1..{n_bricks(grid.res, bz)}")
    return ids


def _conv_cuda(what: str, params: MCConvParams, sample_grid: BucketGrid,
               source_grid: BucketGrid, wf: torch.Tensor, c_out, mean_normalize,
               active: ActiveBricks | None):
    """Launch K9 over every sample cell, or K9a over the cells of the bricks
    ``active.smp`` lists (and, for the full conv, K1's projection GEMM)."""
    wf = wf.contiguous()
    (w1, b1, w2, b2), smp, src = _kernel_inputs(what, params, sample_grid, source_grid, wf)
    B, M = sample_grid.slot_of_point.shape
    N, C = wf.shape[1], wf.shape[2]
    H = w1.shape[1]
    CO = C if c_out is None else c_out
    if CO > dense_conv.MAX_C:
        raise NotImplementedError(f"{what} is built for c_out<={dense_conv.MAX_C}; got {c_out}")
    dev = wf.device
    depthwise = c_out is None
    out = torch.zeros((B, M, CO), dtype=torch.float32, device=dev)
    cnt = torch.zeros((B, M), dtype=torch.float32, device=dev)
    G = None if depthwise else torch.zeros((B, M, H + 1, C), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = _build.stream_of(wf)
    args = [*(_build.ptr(x) for x in (*smp, *src, wf, w1, b1, w2, b2)),
            B, M, N, C, H, sample_grid.res, sample_grid.cap, source_grid.cap]
    tail = [radius_sq(source_grid.radius), float(source_grid.radius), int(mean_normalize),
            int(depthwise), _build.ptr(out if depthwise else G), _build.ptr(cnt), stream]
    if active is None:
        kept = kept_points(sample_grid)
        err = lib.bucket_conv_launch(*args, *tail)
    else:
        ids = _active_ids(what, sample_grid, active.smp, active.bz, wf)
        kept = visited_points(sample_grid, active.smp, active.bz)
        args.insert(11, _build.ptr(ids))
        err = lib.bucket_conv_active_launch(*args, active.smp.nba, active.bz, *tail)
    _build.check(err, what)
    if not depthwise:
        scale = dense_conv._scale(cnt, kept, mean_normalize).contiguous()
        dense_conv.project_full(G, w2, b2, scale, B * M, (H + 1) * C, H * C, c_out, out,
                                f"mcconv_project_full_kernel ({what})")
    return out, cnt


def bucket_conv_cuda(params: MCConvParams, sample_grid: BucketGrid, source_grid: BucketGrid,
                     wf: torch.Tensor, *, c_out=None, mean_normalize=False):
    """Launch K9 (and, for the full conv, K1's projection GEMM); the
    arguments and outputs of the plain version."""
    global launches
    out = _conv_cuda("bucket_conv_kernel (K9)", params, sample_grid, source_grid, wf, c_out,
                     mean_normalize, None)
    launches += 1
    return out


def bucket_conv_active_cuda(params: MCConvParams, sample_grid: BucketGrid,
                            source_grid: BucketGrid, wf: torch.Tensor, active: ActiveBricks, *,
                            c_out=None, mean_normalize=False):
    """Launch K9a (K9 over the visited sample bricks; the full conv's
    projection GEMM after it); the arguments and outputs of the plain
    version."""
    global launches_active
    out = _conv_cuda("bucket_conv_kernel<active> (K9a)", params, sample_grid, source_grid, wf,
                     c_out, mean_normalize, active)
    launches_active += 1
    return out


def _conv_backward_cuda(what: str, params: MCConvParams, sample_grid: BucketGrid,
                        source_grid: BucketGrid, wf: torch.Tensor, cnt: torch.Tensor,
                        dout: torch.Tensor, c_out, mean_normalize, active: ActiveBricks | None,
                        parts: bool = False):
    """Launch K10 over every source cell, or K10a over the cells of the
    bricks ``active.src`` lists (with K2's GEMMs around it for the full
    conv, and K2's reduction for the partial sums). K10a's partials sit
    where K10 puts them, one row block per source cell, and the rest stay
    0: the reduction sums them in the same order. With ``parts``, the
    kernel's own outputs ``(out, w1part, w2part)``, as K6's wrapper gives
    them."""
    wf = wf.contiguous()
    kept = (kept_points(sample_grid) if active is None
            else visited_points(sample_grid, active.smp, active.bz))
    t = (dout * dense_conv._scale(cnt, kept, mean_normalize)[..., None]).contiguous()
    (w1, b1, w2, b2), smp, src = _kernel_inputs(what, params, sample_grid, source_grid, wf, t)
    B, M = sample_grid.slot_of_point.shape
    N, C = wf.shape[1], wf.shape[2]
    H = w1.shape[1]
    H1 = H + 1
    CO = C if c_out is None else c_out
    if CO > dense_conv.MAX_C or tuple(t.shape) != (B, M, CO):
        raise ValueError(f"{what}: dout {tuple(dout.shape)} does not match "
                         f"B={B}, M={M}, c_out={CO}")
    dev = wf.device
    lib = _build.library()
    stream = _build.stream_of(wf)
    depthwise = c_out is None
    R, cap_p = source_grid.res, source_grid.cap
    n_chunks = -(-cap_p // BWD_OWNERS)
    n_blocks = R**3 * n_chunks
    w1part = dense_conv.partials(B * n_blocks, 4 * H, dev)
    if depthwise:
        dG, out, w2part = t, torch.zeros((B, N, C), dtype=torch.float32, device=dev), \
            dense_conv.partials(B * n_blocks, H1 * C, dev)
        # X between the contractions of a block of several passes
        xs = torch.empty((B, N, H1, C), dtype=torch.float32, device=dev)
    else:
        dG = torch.empty((B, M, H1, C), dtype=torch.float32, device=dev)
        dense_conv.dg_full(t, w2, b2, B * M, CO, H * C, H1 * C, dG,
                           f"mcconv_bwd_dg_full_kernel ({what} dG)")
        out, w2part = torch.zeros((B, N, H1, CO), dtype=torch.float32, device=dev), w1part
        xs = None
    args = [*(_build.ptr(x) for x in (*smp, *src, wf, t, dG, w1, b1, w2, b2)),
            B, M, N, C, CO, H, R, sample_grid.cap, cap_p, n_chunks]
    tail = [radius_sq(source_grid.radius), float(source_grid.radius), int(depthwise),
            _build.ptr(out), None if xs is None else _build.ptr(xs), _build.ptr(w1part),
            _build.ptr(w2part), stream]
    if active is None:
        err = lib.bucket_conv_bwd_launch(*args, *tail)
    else:
        ids = _active_ids(what, source_grid, active.src, active.bz, wf)
        args.insert(13, _build.ptr(ids))
        err = lib.bucket_conv_bwd_active_launch(*args, active.src.nba, active.bz, *tail)
    _build.check(err, what)
    if parts:
        return out, w1part, w2part
    return source_grads(MCConvParams(w1, b1, w2, b2), wf, out, w1part, w2part, c_out, what)


def bucket_conv_backward_cuda(params: MCConvParams, sample_grid: BucketGrid,
                              source_grid: BucketGrid, wf: torch.Tensor, cnt: torch.Tensor,
                              dout: torch.Tensor, *, c_out=None, mean_normalize=False):
    """Launch K10 (with K2's GEMMs around it for the full conv, and K2's
    reduction for the partial sums); the arguments and outputs of the plain
    version."""
    global backward_launches
    grads = _conv_backward_cuda("bucket_conv_bwd_kernel (K10)", params, sample_grid,
                                source_grid, wf, cnt, dout, c_out, mean_normalize, None)
    backward_launches += 1
    return grads


def bucket_conv_backward_active_cuda(params: MCConvParams, sample_grid: BucketGrid,
                                     source_grid: BucketGrid, wf: torch.Tensor,
                                     cnt: torch.Tensor, dout: torch.Tensor,
                                     active: ActiveBricks, *, c_out=None, mean_normalize=False):
    """Launch K10a (K10 over the visited source bricks, with the same GEMMs
    and reduction); the arguments and outputs of the plain version."""
    global backward_launches_active
    grads = _conv_backward_cuda("bucket_conv_bwd_kernel<active> (K10a)", params, sample_grid,
                                source_grid, wf, cnt, dout, c_out, mean_normalize, active)
    backward_launches_active += 1
    return grads


# ------------------------------------------------------------------ autograd


class BucketMCConvFunction(torch.autograd.Function):
    """``(w1, b1, w2, b2, wf) -> out``: K9 forward and K10 backward on CUDA
    tensors, their plain versions on CPU tensors; with ``active`` (the brick
    lists of ``active_bricks``) K9a and K10a. ``wf`` is ``features / pdf``
    in source point order; the layouts get no gradient."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, wf, sample_grid, source_grid, c_out, mean_normalize,
                active=None):
        cpu = wf.device.type == "cpu"
        params = MCConvParams(w1, b1, w2, b2)
        kw = dict(c_out=c_out, mean_normalize=mean_normalize)
        if active is None:
            fwd = bucket_conv_reference if cpu else bucket_conv_cuda
            out, cnt = fwd(params, sample_grid, source_grid, wf, **kw)
        else:
            fwd = bucket_conv_active_reference if cpu else bucket_conv_active_cuda
            out, cnt = fwd(params, sample_grid, source_grid, wf, active, **kw)
        ctx.save_for_backward(w1, b1, w2, b2, wf, cnt)
        ctx.grids = (sample_grid, source_grid)
        ctx.conv = (c_out, mean_normalize, active)
        return out

    @staticmethod
    def backward(ctx, dout):
        w1, b1, w2, b2, wf, cnt = ctx.saved_tensors
        c_out, mean, active = ctx.conv
        cpu = wf.device.type == "cpu"
        args = (MCConvParams(w1, b1, w2, b2), *ctx.grids, wf, cnt, dout.contiguous())
        kw = dict(c_out=c_out, mean_normalize=mean)
        if active is None:
            bwd = bucket_conv_backward_reference if cpu else bucket_conv_backward_cuda
            d_wf, dw1, db1, dw2, db2 = bwd(*args, **kw)
        else:
            bwd = bucket_conv_backward_active_reference if cpu else bucket_conv_backward_active_cuda
            d_wf, dw1, db1, dw2, db2 = bwd(*args, active, **kw)
        return dw1, db1, dw2, db2, d_wf, None, None, None, None, None


def bucket_mc_conv(params: MCConvParams, sample_grid: BucketGrid, sample_mask: torch.Tensor,
                   source_grid: BucketGrid, features: torch.Tensor, pdf: torch.Tensor, *,
                   c_out: int | None = None, mean_normalize: bool = False,
                   max_active_bricks: int | None = None) -> torch.Tensor:
    """Monte-Carlo conv over cell-bucket layouts (``mcconv_kernel.py:814``).

    ``sample_grid`` / ``source_grid`` bucketize the out-level / in-level
    points at cell edge = conv radius (``core.buckets.build_buckets``);
    ``features (B, N, C)`` and ``pdf (B, N)`` belong to the in-level points.
    Every in-radius pair of kept points contributes, with no neighbour
    capacity. Returns ``(B, M, C | c_out)``, 0 for masked and dropped
    samples. Differentiable through ``BucketMCConvFunction``.

    ``max_active_bricks`` (NBA) visits only the first NBA bricks of each
    cloud's layouts, occupied bricks first (K9a / K10a): lossless from
    ``count_active_bricks`` on, the dense sweep from the brick count on. A
    sample of a brick past NBA gets 0, and the backward leaves out the
    sources of the source layout's bricks past NBA (``ActiveBricks``)."""
    wf = torch.where(kept_points(source_grid)[..., None], features / pdf[..., None], 0.0)
    active = active_bricks(sample_grid, source_grid, max_active_bricks)
    out = BucketMCConvFunction.apply(*params, wf, sample_grid, source_grid, c_out,
                                     mean_normalize, active)
    if active is not None:
        sample_mask = sample_mask & visited_points(sample_grid, active.smp, active.bz)
    return torch.where(sample_mask[..., None], out, 0.0)
