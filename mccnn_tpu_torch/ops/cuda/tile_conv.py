"""The z-order tile machinery and its kernels (port of
``mccnn_tpu/ops/pallas/tile_conv.py``): K5, the tile MC-conv forward; K6, its
backward; K7, the tile KDE; K8, the tile cover count of the big-scene Poisson
sampler; and the switched variants K5p / K6p (packed records) and K6v1 (the
per-h backward).

Points are sorted along a 3-D Hilbert curve and cut into fixed tiles of
``T = 128`` consecutive points (the majors) and ``Tm = 32`` (the minors, by
default). A sample tile and a candidate minor form a pair when their boxes,
dilated by the radius, touch and each side holds a point near the other's box
(``_refined_adjacency``, a conservative test: no in-radius pair is lost). The
pairs become a chunked step list: step ``k`` of cloud ``b`` is one sample tile
``i_ids[b, k]`` (non-decreasing) and up to ``G = chunk * T / Tm`` of its
candidate minors ``j_ids[b, :, k]`` (``n_minor`` = none). A static step
budget ``S`` bounds the list; steps beyond it are dropped and counted as
overflow, as in the reference. All of this host-side machinery is integer and
boolean tensor code that equals the JAX package's exactly; it runs on the
tensors' device.

The conv's backward walks a second list, as the reference's does: source
majors x sample minors (``jb_ids`` / ``ib_ids`` there), built only when a
gradient is wanted. When a budget is short the two lists drop different
pairs, so the backward is the gradient of what the backward list reaches, as
in the reference, not of the forward.

The kernels (``csrc/tile_conv.cuh`` for K5 and K5p, ``csrc/tile_conv_bwd.cuh``
for K6 and K6p, ``csrc/tile_conv_bwd_v1.cu`` for K6v1, ``csrc/tile_sweep.cu``
for K7 and K8, each templated on the minor size) give one block to each
(cloud, major tile), K6v1 also to each channel block, and K5 and K6 one to
each group of 16 or 32 of the tile's points (and, where the groups would not
fill the card, to each slice of the channels); every block walks its tile's
contiguous run of steps (``run[b, t]`` to ``run[b, t + 1]``, built with
``searchsorted``). K5 and K6 sweep the run once into in-radius pair lists
and contract those over all their channels (``csrc/list_fwd.cuh``,
``csrc/list_bwd.cuh``). Every output row has one writer and the sums run in
step order, so two calls are bit-identical. Each kernel has a plain PyTorch
version that walks the same step list, so it drops exactly what the kernel
drops when the budget is short. The public functions (``tile_mc_conv``,
``tile_kde``, ``TileCoverSweep.counts``) pick by device: CPU tensor -> plain
version, CUDA tensor -> kernel; ``tile_mc_conv`` goes through
``TileMCConvFunction`` on both.

Invalid rows are masked explicitly. The reference parks them at a far
``SENTINEL`` coordinate, where the expanded d2 of two sentinels cancels to
about 0, an "in-radius" pair that only later masking hides; here positions of
invalid and padding rows are 0 and a validity flag rides beside them.

The reference's environment switches are read once, when this module is
imported, into module constants that every call consults (tests set them
with ``monkeypatch.setattr``), as the reference reads them when it traces:

- ``MCCNN_TILE_ORDER=morton`` (``_ORDER``): Morton order instead of Hilbert
  (``curve_order``).
- ``MCCNN_TILE_ADJ=aabb`` (``_ADJ``): the box test alone, without the
  point-near-box refinement (``_refined_adjacency``).
- ``MCCNN_TILE_MINOR=m`` (``_MINOR``): minors of ``m`` points, any ``m``
  with ``128 % m == 0`` and ``m % 8 == 0`` (``tile_minor``); the step chunk
  becomes ``G = chunk * T / m``. At ``m = T`` the backward adjacency is the
  transpose of the forward one, as in the reference. K5-K8 are built for
  every such ``m``.
- ``MCCNN_TILE_PACK=1`` (``_PACK``): K5p and K6p, which read each candidate
  minor's positions, validity and payload (``features / pdf`` forward, the
  cotangent backward) from one contiguous record (``pack_minor_records``).
  Not with ``MCCNN_TILE_BWD_V1=1``: then K5 and K6v1 run, as in the
  reference.
- ``MCCNN_TILE_BWD_V1=1`` (``_BWD_V1``): K6v1, the reference's per-h
  backward (``csrc/tile_conv_bwd_v1.cu``), over the same source-major list.
- ``MCCNN_TILE_PROBE`` (``_PROBE``): the reference's roofline probes
  (``:575-608``, ``:718-726``), which strip K5 and K6 to their parts for
  a roofline (``mccnn_tpu_torch.tools.tile_roofline``) and give another
  value than the conv by design. ``noop``, ``planes`` and ``mm`` change only
  the forward kernel
  (K5, or K5p under ``_PACK``): 0; the sum over h and the step's sources of
  the masked ReLU'd planes ``(cw_h(j) - sw_h(i)) + b1_h``, the same in every
  channel; the raw d2 of every valid candidate pair in place of each a_h.
  ``bwd_noop`` changes only the backward kernel (K6, or K6p): every gradient
  0. K6v1 ignores them, as ``_bwd_kernel_v1`` does. The layout, the step
  lists, the count and the mean normalisation are the conv's. Any other
  value raises ``ValueError`` (the reference runs the conv then, ROADMAP
  queue 3).

On CPU tensors every variant runs its plain version, on CUDA tensors its
kernel.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ...core.gather import batched_gather
from ...core.grid import pair_d2, radius_sq
from ...core.mcconv import MCConvParams
from . import _build, dense_conv

DEFAULT_TILE = 128
DEFAULT_CHUNK = 8
DEFAULT_MINOR = 32
DEFAULT_COVER_CHUNK = 8
MORTON_BITS = 8  # 256 curve cells per axis
_BIG_I32 = 2**30
STEP_CHUNK = 8  # steps per pass of the plain versions
TILE_BWD_CHANNELS = 16  # K6v1's channel block (csrc/tile_conv_bwd_v1.cu kMaxCB)
BUILT_MINORS = (8, 16, 32, 64, 128)  # the minor sizes K5-K8 are compiled for
# K6v1's dW2 partials (one per source tile) stay within this many floats: 256 MiB.
_V1_PARTIAL_FLOATS = 64 << 20

# The reference's switches (mccnn_tpu/ops/pallas/tile_conv.py :190, :265,
# :390, :1359-1360, :1036, :1366): read once here, consulted at every call.
_ORDER = os.environ.get("MCCNN_TILE_ORDER", "")
_ADJ = os.environ.get("MCCNN_TILE_ADJ", "")
_MINOR = os.environ.get("MCCNN_TILE_MINOR", "")
_PACK = os.environ.get("MCCNN_TILE_PACK") == "1"
_BWD_V1 = os.environ.get("MCCNN_TILE_BWD_V1") == "1"
_PROBE = os.environ.get("MCCNN_TILE_PROBE", "")

# The probes' values of MCCNN_TILE_PROBE, and their ids in csrc/tile_conv.cuh.
FORWARD_PROBES = {"noop": 1, "planes": 2, "mm": 3}
BACKWARD_PROBES = ("bwd_noop",)

# Launches of each kernel since the last reset (see density_kernel.py).
launches = 0  # K5
backward_launches = 0  # K6
kde_launches = 0  # K7
cover_launches = 0  # K8
packed_launches = 0  # K5p
packed_backward_launches = 0  # K6p
backward_v1_launches = 0  # K6v1
launches_probe = dict.fromkeys(FORWARD_PROBES, 0)  # the K5 / K5p probes, by probe
backward_launches_probe = 0  # the K6 / K6p bwd_noop probe


# ---------------------------------------------------------------- curve order


def hilbert_code(c: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer coords ``(..., 3)`` in ``[0, 2**bits)`` -> 3-D Hilbert index
    (int32; ``3 * bits <= 30``): Skilling's transform, as ``tile_conv.py:133``."""
    assert 3 * bits <= 30, bits
    X = [c[..., 0], c[..., 1], c[..., 2]]
    n = 3
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(n):
            t = (X[i] & Q) != 0
            X[0] = torch.where(t, X[0] ^ P, X[0])
            tt = (X[i] & Q) == 0
            tmp = (X[0] ^ X[i]) & P
            X[0] = torch.where(tt, X[0] ^ tmp, X[0])
            X[i] = torch.where(tt, X[i] ^ tmp, X[i])
        Q >>= 1
    for i in range(1, n):  # Gray encode
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[n - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]
    code = torch.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):
        for i in range(n):
            code = (code << 1) | ((X[i] >> b) & 1)
    return code


def hilbert_order(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N) stable argsort of the Hilbert index; invalid points sort last."""
    res = 1 << MORTON_BITS
    c = (points * res).to(torch.int32).clamp(0, res - 1)
    code = torch.where(mask, hilbert_code(c, MORTON_BITS), _BIG_I32)
    return torch.argsort(code, dim=-1, stable=True)


def morton_order(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N) stable argsort of the 3-D Morton code, bit ``b`` of axis ``d``
    at bit ``3 b + d``; invalid points sort last (``tile_conv.py:121``)."""
    res = 1 << MORTON_BITS
    c = (points * res).to(torch.int32).clamp(0, res - 1)
    code = torch.zeros(points.shape[:-1], dtype=torch.int32, device=points.device)
    for b in range(MORTON_BITS):
        for d in range(3):
            code = code | (((c[..., d] >> b) & 1) << (3 * b + d))
    code = torch.where(mask, code, _BIG_I32)
    return torch.argsort(code, dim=-1, stable=True)


def curve_order(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The ordering every tile function shares: Hilbert, or Morton under
    ``MCCNN_TILE_ORDER=morton`` (``tile_conv.py:186``)."""
    if _ORDER == "morton":
        return morton_order(points, mask)
    return hilbert_order(points, mask)


def tile_minor(tile: int = DEFAULT_TILE) -> int:
    """Candidate-side minor tile: ``min(tile, 32)``, or ``MCCNN_TILE_MINOR``,
    which must divide ``tile`` and be a multiple of 8 (``tile_conv.py:387``)."""
    m = int(_MINOR) if _MINOR else min(tile, DEFAULT_MINOR)
    if m < 8 or tile % m or m % 8:
        raise ValueError(f"MCCNN_TILE_MINOR={_MINOR!r}: the minor tile must divide the tile "
                         f"({tile}) and be a multiple of 8")
    return m


# ---------------------------------------------------------------- tiles


def _sorted_rows(points, mask, order, n_rows):
    """Positions (B, n_rows, 3) and validity (B, n_rows) in ``order``, padded
    with invalid rows; invalid rows hold 0."""
    B, N, _ = points.shape
    p = torch.gather(points, 1, order[..., None].expand(B, N, 3))
    v = torch.gather(mask, 1, order)
    p = torch.where(v[..., None], p, 0.0)
    pad = n_rows - N
    if pad:
        p = torch.cat([p, p.new_zeros((B, pad, 3))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad))], dim=1)
    return p, v


def _tile_boxes(p, v, T):
    """Per-tile boxes of the valid points: ``mn``, ``mx`` (B, n_rows // T, 3),
    +inf / -inf for a tile with none (``_sorted_tiles``, ``tile_conv.py:195``)."""
    B, n_rows, _ = p.shape
    nt = n_rows // T
    mn = torch.where(v[..., None], p, math.inf).reshape(B, nt, T, 3).amin(dim=2)
    mx = torch.where(v[..., None], p, -math.inf).reshape(B, nt, T, 3).amax(dim=2)
    return mn, mx


def _tile_adjacency(mn_i, mx_i, mn_j, mx_j, radius):
    """(B, n_i, n_j): box i dilated by ``radius`` meets box j (``:217``)."""
    lo = mn_i[:, :, None, :] - radius <= mx_j[:, None, :, :]
    hi = mx_i[:, :, None, :] + radius >= mn_j[:, None, :, :]
    return (lo & hi).all(dim=-1)


def _points_near_boxes(p, v, mn, mx, T, radius):
    """(B, n_rows // T, n_boxes): some valid point of tile a lies within
    ``radius`` of box b, with the reference's 1e-5 relative slack (``:226``)."""
    B, n_rows, _ = p.shape
    ntb = mn.shape[1]
    d2 = p.new_zeros((B, n_rows, ntb))
    for d in range(3):
        x = p[..., d][..., None]
        lo = (mn[:, None, :, d] - x).clamp_min(0.0)
        hi = (x - mx[:, None, :, d]).clamp_min(0.0)
        s = lo + hi
        d2 = d2 + s * s
    thr = float(np.float32(float(radius) * float(radius) * (1.0 + 1e-5)))
    near = (d2 <= thr) & v[..., None]
    return near.reshape(B, n_rows // T, T, ntb).any(dim=2)


def _refined_adjacency(smp, smp_v, mn_i, mx_i, src, src_v, mn_j, mx_j, T, radius, Tm):
    """Box-box adjacency of sample majors (``T``) and source minors (``Tm``),
    intersected with the point-near-box test both ways (``:254``); the box
    test alone under ``MCCNN_TILE_ADJ=aabb``."""
    nts, ntp = mn_i.shape[1], mn_j.shape[1]
    adj = _tile_adjacency(mn_i, mx_i, mn_j, mx_j, radius)
    if _ADJ == "aabb":
        return adj
    near_ij = _points_near_boxes(smp[:, : nts * T], smp_v[:, : nts * T], mn_j, mx_j, T, radius)
    near_ji = _points_near_boxes(src[:, : ntp * Tm], src_v[:, : ntp * Tm], mn_i, mx_i, Tm,
                                 radius)
    return adj & near_ij & near_ji.transpose(1, 2)


def _chunked_pair_lists(adj, S_steps, G, pad_major, sentinel_minor):
    """Chunked step list over ``adj`` (B, n_major, n_minor): ``major`` (B, S)
    non-decreasing, padded with ``pad_major``, and ``minors`` (B, G, S), padded
    with ``sentinel_minor`` (``:276``). Each step holds one major and up to G
    of its true minors, in ascending id order; the list is padded to
    ``S_steps`` with inert steps and never truncated below it."""
    B, n_major, n_minor = adj.shape
    dev = adj.device
    order = torch.argsort((~adj).to(torch.int32), dim=-1, stable=True).to(torch.int32)
    cnt = adj.sum(dim=-1)
    rank = torch.arange(n_minor, device=dev)
    minors_full = torch.where(rank < cnt[..., None], order, sentinel_minor)
    n_chunks = -(-n_minor // G)
    pad = n_chunks * G - n_minor
    if pad:
        minors_full = torch.cat(
            [minors_full, minors_full.new_full((B, n_major, pad), sentinel_minor)], dim=-1)
    chunks = minors_full.reshape(B, n_major * n_chunks, G)
    occ = torch.arange(n_chunks, device=dev) * G < cnt[..., None]
    occ_flat = occ.reshape(B, n_major * n_chunks)
    sel = torch.argsort((~occ_flat).to(torch.int32), dim=-1, stable=True)[:, :S_steps]
    real = torch.gather(occ_flat, 1, sel)
    major = torch.where(real, sel // n_chunks, pad_major).to(torch.int32)
    idx = torch.where(real, sel, 0)
    minors = torch.gather(chunks, 1, idx[..., None].expand(*idx.shape, G))
    minors = torch.where(real[..., None], minors, sentinel_minor).to(torch.int32)
    L = major.shape[1]
    if L < S_steps:
        major = torch.cat([major, major.new_full((B, S_steps - L), pad_major)], dim=1)
        minors = torch.cat(
            [minors, minors.new_full((B, S_steps - L, G), sentinel_minor)], dim=1)
    return major.contiguous(), minors.transpose(1, 2).contiguous()


def _steps_for_pairs(max_pairs, G, n_major, n_minor):
    """Static step budget that holds any ``max_pairs`` pairs (``:329``)."""
    full = -(-max_pairs // G) + n_major
    return min(full, n_major * (-(-n_minor // G)))


def _needed_steps(adj, G):
    """(B,) steps the chunked list needs to hold every pair of ``adj`` (``:336``)."""
    cnt = adj.sum(dim=-1)
    return ((cnt + G - 1) // G).sum(dim=-1)


def _count_adjacency(sample_pts, sample_mask, src_pts, src_mask, radius, tile, minor):
    """The adjacency one list direction sees: sample majors x source minors."""
    M, N = sample_pts.shape[1], src_pts.shape[1]
    nts, ntp = -(-M // tile), -(-N // minor)
    smp, smp_v = _sorted_rows(sample_pts, sample_mask, curve_order(sample_pts, sample_mask),
                              nts * tile)
    src, src_v = _sorted_rows(src_pts, src_mask, curve_order(src_pts, src_mask), ntp * minor)
    mn_i, mx_i = _tile_boxes(smp, smp_v, tile)
    mn_j, mx_j = _tile_boxes(src, src_v, minor)
    return _refined_adjacency(smp, smp_v, mn_i, mx_i, src, src_v, mn_j, mx_j, tile, radius,
                              minor)


def count_tile_pairs(sample_pts, sample_mask, src_pts, src_mask, radius,
                     tile: int = DEFAULT_TILE) -> torch.Tensor:
    """(B,) surviving tile-pair count, the max over both list directions (``:419``)."""
    minor = tile_minor(tile)
    fwd = _count_adjacency(sample_pts, sample_mask, src_pts, src_mask, radius, tile,
                           minor).sum(dim=(1, 2))
    if minor == tile:
        return fwd
    bwd = _count_adjacency(src_pts, src_mask, sample_pts, sample_mask, radius, tile,
                           minor).sum(dim=(1, 2))
    return torch.maximum(fwd, bwd)


def count_tile_steps(sample_pts, sample_mask, src_pts, src_mask, radius,
                     tile: int = DEFAULT_TILE, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(B,) chunked-step demand, the max over both list directions: the exact
    lossless ``max_steps`` of ``tile_mc_conv`` on these inputs (``:446``)."""
    minor = tile_minor(tile)
    gm = chunk * (tile // minor)
    fwd = _count_adjacency(sample_pts, sample_mask, src_pts, src_mask, radius, tile, minor)
    bwd = (fwd.transpose(1, 2) if minor == tile else
           _count_adjacency(src_pts, src_mask, sample_pts, sample_mask, radius, tile, minor))
    return torch.maximum(_needed_steps(fwd, gm), _needed_steps(bwd, gm))


def auto_tile_pairs(pts, mask, radius: float, *, tile: int = DEFAULT_TILE,
                    chunk: int = DEFAULT_CHUNK, headroom: float = 1.3,
                    multiple: int = 256) -> int:
    """Static ``max_pairs`` sized from a representative batch's measured step
    demand (``:344``): the batch max of ``count_tile_steps`` against itself,
    times ``headroom``, with the step formula inverted and rounded up to
    ``multiple``."""
    N = pts.shape[1]
    nt = -(-N // tile)
    need = int(count_tile_steps(pts, mask, pts, mask, radius, tile, chunk).max())
    target_s = int(need * headroom) + 1
    gm = chunk * (tile // tile_minor(tile))
    n = max(gm * (target_s - nt), gm)
    return -(-n // multiple) * multiple


# ---------------------------------------------------------------- step lists


class StepList(NamedTuple):
    """A chunked step list and the per-tile runs the kernels walk."""

    i_ids: torch.Tensor  # (B, S) int32, non-decreasing sample-tile ids
    j_ids: torch.Tensor  # (B, G, S) int32 candidate-minor ids (n_minor = none)
    run: torch.Tensor  # (B, n_major + 1) int32: tile t walks steps run[t]:run[t+1]
    n_minor: int  # the sentinel minor id
    need: torch.Tensor  # (B,) steps this direction needs for every pair
    Tm: int  # points per minor


def _step_list(adj, S, G, Tm) -> StepList:
    B, n_major, n_minor = adj.shape
    i_ids, j_ids = _chunked_pair_lists(adj, S, G, n_major - 1, n_minor)
    tiles = torch.arange(n_major + 1, device=adj.device, dtype=torch.int32)
    run = torch.searchsorted(i_ids, tiles.expand(B, n_major + 1).contiguous())
    return StepList(i_ids, j_ids, run.to(torch.int32).contiguous(), n_minor,
                    _needed_steps(adj, G), Tm)


def real_steps(steps: StepList) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) real and inert steps of a list: a real step's minors come first,
    so slot 0 tells them apart. The inert ones pad the list to its budget,
    all in the last tile's run and after its real steps: K7 and K8 stop a
    run at its first inert step."""
    real = (steps.j_ids[:, 0, :] != steps.n_minor).sum(dim=1)
    return real, steps.j_ids.shape[2] - real


def _walk_steps(steps: StepList, T: int):
    """Yield, per chunk of steps of the plain versions: the major rows (B, Sc,
    T), the candidate rows (B, Sc, G*Tm), whether each candidate row is a
    real minor's (B, Sc, G*Tm), and the flat (b, tile) index of each step."""
    B, G, S = steps.j_ids.shape
    Tm = steps.Tm
    n_major = steps.run.shape[1] - 1
    dev = steps.i_ids.device
    ar_t = torch.arange(T, device=dev)
    ar_m = torch.arange(Tm, device=dev)
    base = torch.arange(B, device=dev)[:, None] * n_major
    for k0 in range(0, S, STEP_CHUNK):
        ii = steps.i_ids[:, k0:k0 + STEP_CHUNK].long()
        jj = steps.j_ids[:, :, k0:k0 + STEP_CHUNK].long().transpose(1, 2)  # (B, Sc, G)
        # a step's real minors come first: drop the columns no step fills
        jj = jj[..., : max(1, int((jj != steps.n_minor).sum(-1).max()))]
        real = (jj != steps.n_minor)[..., None].expand(*jj.shape, Tm)
        cand = (jj.clamp(max=steps.n_minor - 1)[..., None] * Tm + ar_m)
        smp_rows = ii[..., None] * T + ar_t
        yield (smp_rows, cand.flatten(2), real.flatten(2), (base + ii).reshape(-1))


# ---------------------------------------------------------------- K5: tile conv


class ConvLayout(NamedTuple):
    """Sorted sample and source rows and the step lists of one site. The
    minor rows of each side are a prefix of its major rows."""

    order_s: torch.Tensor  # (B, M) sample curve order
    order_p: torch.Tensor  # (B, N) source curve order
    smp: torch.Tensor  # (B, nts*T, 3) sorted sample positions (invalid rows 0)
    smp_valid: torch.Tensor  # (B, nts*T)
    src: torch.Tensor  # (B, ntp*T, 3) sorted source positions
    src_valid: torch.Tensor  # (B, ntp*T)
    steps: StepList  # forward list: sample majors x source minors
    steps_b: StepList | None  # backward list: source majors x sample minors
    S: int
    overflow: torch.Tensor  # (B,) dropped steps, max over both directions


def conv_layout(sample_pts, sample_mask, src_pts, src_mask, radius: float, *,
                max_pairs: int, max_steps: int | None = None, tile: int = DEFAULT_TILE,
                chunk: int = DEFAULT_CHUNK, backward: bool = False) -> ConvLayout:
    """The layout ``tile_mc_conv`` builds (``tile_conv.py:1265-1342``): both
    curve orders, the forward (sample-major) and backward (source-major)
    adjacencies, one static step budget ``S`` for both, the forward list and,
    with ``backward``, the backward list."""
    T = tile
    Tm = tile_minor(T)
    Gm = chunk * (T // Tm)
    M, N = sample_pts.shape[1], src_pts.shape[1]
    nts, ntp = -(-M // T), -(-N // T)
    nts_m, ntp_m = -(-M // Tm), -(-N // Tm)
    order_s = curve_order(sample_pts, sample_mask)
    order_p = curve_order(src_pts, src_mask)
    smp, smp_v = _sorted_rows(sample_pts, sample_mask, order_s, nts * T)
    src, src_v = _sorted_rows(src_pts, src_mask, order_p, ntp * T)
    mn_i, mx_i = _tile_boxes(smp, smp_v, T)
    mn_j, mx_j = _tile_boxes(src, src_v, T)
    mn_i_m, mx_i_m = _tile_boxes(smp[:, : nts_m * Tm], smp_v[:, : nts_m * Tm], Tm)
    mn_j_m, mx_j_m = _tile_boxes(src[:, : ntp_m * Tm], src_v[:, : ntp_m * Tm], Tm)
    adj_f = _refined_adjacency(smp, smp_v, mn_i, mx_i, src, src_v, mn_j_m, mx_j_m, T, radius,
                               Tm)
    # at Tm == T the reference transposes the forward adjacency (:1329-1335):
    # box compares that are equal in exact arithmetic may round apart swapped
    adj_b = (adj_f.transpose(1, 2) if Tm == T else
             _refined_adjacency(src, src_v, mn_j, mx_j, smp, smp_v, mn_i_m, mx_i_m, T, radius,
                                Tm))
    cap_f = min(max_pairs, nts * ntp_m)
    cap_b = min(max_pairs, ntp * nts_m)
    S = max(_steps_for_pairs(cap_f, Gm, nts, ntp_m), _steps_for_pairs(cap_b, Gm, ntp, nts_m))
    if max_steps is not None:
        S = min(S, max(int(max_steps), 1))
    steps = _step_list(adj_f, S, Gm, Tm)
    steps_b = _step_list(adj_b, S, Gm, Tm) if backward else None
    need = torch.maximum(steps.need, _needed_steps(adj_b, Gm))
    return ConvLayout(order_s, order_p, smp.contiguous(), smp_v.contiguous(), src.contiguous(),
                      src_v.contiguous(), steps, steps_b, S, (need - S).clamp_min(0))


def _sorted_weighted_features(lay: ConvLayout, features, pdf):
    """``features / pdf`` in source curve order, 0 on invalid rows (B, ntp*T, C)."""
    wf = features / pdf[..., None]
    B, N, C = wf.shape
    wf = torch.gather(wf, 1, lay.order_p[..., None].expand(B, N, C))
    pad = lay.src.shape[1] - N
    if pad:
        wf = torch.cat([wf, wf.new_zeros((B, pad, C))], dim=1)
    return torch.where(lay.src_valid[..., None], wf, 0.0)


def tile_conv_sorted_reference(params: MCConvParams, lay: ConvLayout, wf: torch.Tensor,
                               radius: float, *, c_out=None, mean_normalize=False):
    """Plain version of K5 on the sorted layout: ``(out (B, nts*T, C | c_out),
    cnt (B, nts*T))``, scaled and 0 on invalid sample rows. It walks the step
    list like the kernel and projects G as the dense conv's plain version."""
    w1, b1 = params.w1, params.b1
    H = w1.shape[1]
    B, NS, _ = lay.smp.shape
    C = wf.shape[-1]
    T = DEFAULT_TILE
    nts = NS // T
    r2 = radius_sq(radius)
    G = wf.new_zeros((B * nts, T, H + 1, C))
    cnt = wf.new_zeros((B * nts, T))
    for smp_rows, cand_rows, real, tiles in _walk_steps(lay.steps, T):
        Sc = smp_rows.shape[1]
        q = batched_gather(lay.smp, smp_rows).reshape(B * Sc, T, 3)
        qv = batched_gather(lay.smp_valid, smp_rows).reshape(B * Sc, T)
        p = batched_gather(lay.src, cand_rows).reshape(B * Sc, -1, 3)
        pv = (batched_gather(lay.src_valid, cand_rows) & real).reshape(B * Sc, -1)
        f = batched_gather(wf, cand_rows).reshape(B * Sc, -1, C)
        inr = (pair_d2(q, p) <= r2) & qv[:, :, None] & pv[:, None, :]
        off = (p[:, None, :, :] - q[:, :, None, :]) / radius
        act = torch.relu(off @ w1 + b1)
        a = torch.cat([act, torch.ones_like(act[..., :1])], dim=-1) * inr[..., None]
        G.index_add_(0, tiles, torch.einsum("stnh,snc->sthc", a, f))
        cnt.index_add_(0, tiles, inr.sum(dim=-1).to(wf.dtype))
    G = G.reshape(B, NS, H + 1, C)
    cnt = cnt.reshape(B, NS)
    out = dense_conv.project_reference(params, G, cnt, lay.smp_valid, c_out, mean_normalize)
    return out, cnt


def pack_minor_records(pos, valid, payload, Tm: int, n_minor: int) -> torch.Tensor:
    """One contiguous record per minor tile, ``(B, n_minor, Tm * (4 + C))``:
    the tile's Tm position rows (x, y, z and its validity as 1 / 0), then its
    Tm payload rows of C, from sorted rows ``pos (B, >= n_minor*Tm, 3)``,
    ``valid`` and ``payload (B, >= n_minor*Tm, C)``. The reference's
    ``_pack_minor`` (``tile_conv.py:487``) bit-casts a bf16 payload into f32
    rows; the port is fp32 throughout, so the payload stays fp32."""
    B, rows = pos.shape[0], n_minor * Tm
    head = torch.cat([pos[:, :rows], valid[:, :rows, None].to(pos.dtype)], dim=-1)
    return torch.cat([head.reshape(B, n_minor, Tm * 4),
                      payload[:, :rows].reshape(B, n_minor, -1)], dim=-1).contiguous()


def unpack_minor_records(rec: torch.Tensor, Tm: int):
    """The rows of ``pack_minor_records``, read from the records: positions
    (B, n*Tm, 3), validity (B, n*Tm) and payload (B, n*Tm, C)."""
    B, n, R = rec.shape
    head = rec[..., : 4 * Tm].reshape(B, n * Tm, 4)
    return head[..., :3], head[..., 3] != 0, rec[..., 4 * Tm:].reshape(B, n * Tm, R // Tm - 4)


def tile_conv_sorted_packed_reference(params: MCConvParams, lay: ConvLayout, wf: torch.Tensor,
                                      radius: float, *, c_out=None, mean_normalize=False):
    """Plain version of K5p: packs the source minors' records and walks the
    step list over them; bit-equal to ``tile_conv_sorted_reference``."""
    st = lay.steps
    src, src_valid, wf_m = unpack_minor_records(
        pack_minor_records(lay.src, lay.src_valid, wf, st.Tm, st.n_minor), st.Tm)
    return tile_conv_sorted_reference(params, lay._replace(src=src, src_valid=src_valid), wf_m,
                                      radius, c_out=c_out, mean_normalize=mean_normalize)


def tile_conv_probe_sorted_reference(probe: str, params: MCConvParams, lay: ConvLayout,
                                     wf: torch.Tensor, radius: float, *, c_out=None,
                                     mean_normalize=False):
    """Plain version of K5's probe ``probe`` (``noop``, ``planes`` or ``mm``)
    on the sorted layout: ``(out (B, nts*T, C | c_out), cnt)``, the count and
    scaling of K5's. ``noop``: out 0. ``planes``: per sample, the sum over
    its steps' candidates j and over h of ``relu((cw_h(j) - sw_h(i)) + b1_h)``
    on the in-radius pairs (``dense_conv._factored_preact``, with ``/ r`` as
    ``tile_conv.py:578-591``), in every channel. ``mm``: K5's G and
    projection with the raw d2 of every valid candidate pair as each a_h
    (h < H) and the radius mask as a_H (``:595-607``): ``sum_h (d2^T f~) w2_h
    + (mask^T f~) b2``."""
    if probe not in FORWARD_PROBES:
        raise ValueError(f"tile_conv_probe_sorted_reference: {probe!r} is not a forward probe "
                         f"({', '.join(FORWARD_PROBES)})")
    w1, b1 = params.w1, params.b1
    H = w1.shape[1]
    B, NS, _ = lay.smp.shape
    C = wf.shape[-1]
    CO = C if c_out is None else c_out
    T = DEFAULT_TILE
    nts = NS // T
    r2 = radius_sq(radius)
    acc = wf.new_zeros((B * nts, T))
    G = wf.new_zeros((B * nts, T, H + 1, C)) if probe == "mm" else None
    cnt = wf.new_zeros((B * nts, T))
    for smp_rows, cand_rows, real, tiles in _walk_steps(lay.steps, T):
        Sc = smp_rows.shape[1]
        q = batched_gather(lay.smp, smp_rows).reshape(B * Sc, T, 3)
        qv = batched_gather(lay.smp_valid, smp_rows).reshape(B * Sc, T)
        p = batched_gather(lay.src, cand_rows).reshape(B * Sc, -1, 3)
        pv = (batched_gather(lay.src_valid, cand_rows) & real).reshape(B * Sc, -1)
        d2 = pair_d2(q, p)
        valid = qv[:, :, None] & pv[:, None, :]
        inr = (d2 <= r2) & valid
        cnt.index_add_(0, tiles, inr.sum(dim=-1).to(wf.dtype))
        if probe == "planes":
            pre = dense_conv._factored_preact(q, p, w1, b1, radius)
            acc.index_add_(0, tiles, (torch.relu(pre) * inr[..., None]).sum(dim=(2, 3)))
        elif probe == "mm":
            f = batched_gather(wf, cand_rows).reshape(B * Sc, -1, C)
            a = torch.cat([(d2 * valid)[..., None].expand(*d2.shape, H),
                           inr[..., None].to(wf.dtype)], dim=-1)
            G.index_add_(0, tiles, torch.einsum("stnh,snc->sthc", a, f))
    cnt = cnt.reshape(B, NS)
    if probe == "mm":
        out = dense_conv.project_reference(params, G.reshape(B, NS, H + 1, C), cnt,
                                           lay.smp_valid, c_out, mean_normalize)
        return out, cnt
    scale = dense_conv._scale(cnt, lay.smp_valid, mean_normalize)
    val = acc.reshape(B, NS) if probe == "planes" else torch.zeros_like(cnt)
    return (val * scale)[..., None].expand(B, NS, CO).contiguous(), cnt


def _check_minor(name: str, Tm: int) -> None:
    if Tm not in BUILT_MINORS:
        raise NotImplementedError(f"{name} is built for minors {BUILT_MINORS}; got Tm={Tm}")


def _launch_k5(params: MCConvParams, lay: ConvLayout, wf, radius, c_out, mean_normalize,
               packed: bool, probe: str = ""):
    """K5 or, with ``packed``, K5p on the sorted layout; with ``probe``, that
    probe of the kernel."""
    name = ("tile_mc_conv (K5p" if packed else "tile_mc_conv (K5") + (f" {probe})" if probe
                                                                      else ")")
    w1, b1, w2, b2 = (t.contiguous() for t in params)
    wf = wf.contiguous()
    st = lay.steps
    _build.require_cuda(name, lay.smp, lay.smp_valid, lay.src, lay.src_valid, wf, st.j_ids,
                        st.run, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 for t in (lay.smp, lay.src, wf, w1, b1, w2, b2)):
        raise TypeError(f"{name}: positions, features and params must be float32")
    B, NS, _ = lay.smp.shape
    NP = lay.src.shape[1]
    C = wf.shape[-1]
    H = w1.shape[1]
    if H != dense_conv.HIDDEN or C > dense_conv.MAX_C:
        raise NotImplementedError(f"{name} is built for H={dense_conv.HIDDEN} and "
                                  f"C<={dense_conv.MAX_C}; got H={H}, C={C}")
    _check_minor(name, st.Tm)
    T = DEFAULT_TILE
    nts = NS // T
    S = st.i_ids.shape[1]
    Gm = st.j_ids.shape[1]
    dev = wf.device
    CO = C if c_out is None else c_out
    cnt = torch.empty((B, NS), dtype=torch.float32, device=dev)
    out = torch.empty((B, NS, CO), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = _build.stream_of(wf)
    depthwise = c_out is None
    one = probe in ("noop", "planes")  # the probe writes one value a sample
    G = None if depthwise or one else torch.empty((B, NS, H + 1, C), dtype=torch.float32,
                                                  device=dev)
    val = torch.empty((B, NS), dtype=torch.float32, device=dev) if one else None
    dst = _build.ptr(val if one else out if depthwise else G)
    tail = (B, NS, C, H, S, Gm, nts, st.n_minor, st.Tm, radius_sq(radius), float(radius),
            int(mean_normalize), int(depthwise), dst, _build.ptr(cnt), stream)
    weights = (_build.ptr(st.j_ids), _build.ptr(st.run), _build.ptr(w1), _build.ptr(b1),
               _build.ptr(w2), _build.ptr(b2))
    head = (FORWARD_PROBES[probe],) if probe else ()
    if packed:
        rec = pack_minor_records(lay.src, lay.src_valid, wf, st.Tm, st.n_minor)
        launch = lib.tile_conv_packed_probe_launch if probe else lib.tile_conv_packed_launch
        err = launch(*head, _build.ptr(lay.smp), _build.ptr(lay.smp_valid), _build.ptr(rec),
                     *weights, *tail)
    else:
        launch = lib.tile_conv_probe_launch if probe else lib.tile_conv_launch
        err = launch(*head, _build.ptr(lay.smp), _build.ptr(lay.smp_valid), _build.ptr(lay.src),
                     _build.ptr(lay.src_valid), _build.ptr(wf), *weights, NP, *tail)
    _build.check(err, ("tile_conv_packed_kernel" if packed else "tile_conv_kernel")
                 + (f" ({probe} probe)" if probe else ""))
    if one:
        scale = dense_conv._scale(cnt, lay.smp_valid, mean_normalize)
        return (val * scale)[..., None].expand(B, NS, CO).contiguous(), cnt
    if not depthwise:
        scale = dense_conv._scale(cnt, lay.smp_valid, mean_normalize).contiguous()
        dense_conv.project_full(G, w2, b2, scale, B * NS, (H + 1) * C, H * C, c_out, out,
                                f"mcconv_project_full_kernel ({name})")
    return out, cnt


def tile_conv_sorted_cuda(params: MCConvParams, lay: ConvLayout, wf: torch.Tensor,
                          radius: float, *, c_out=None, mean_normalize=False):
    """Launch K5 on the sorted layout; the outputs of the plain version."""
    global launches
    res = _launch_k5(params, lay, wf, radius, c_out, mean_normalize, packed=False)
    launches += 1
    return res


def tile_conv_sorted_packed_cuda(params: MCConvParams, lay: ConvLayout, wf: torch.Tensor,
                                 radius: float, *, c_out=None, mean_normalize=False):
    """Launch K5p (K5 over packed source records); bit-equal to K5."""
    global packed_launches
    res = _launch_k5(params, lay, wf, radius, c_out, mean_normalize, packed=True)
    packed_launches += 1
    return res


def tile_conv_probe_sorted_cuda(probe: str, params: MCConvParams, lay: ConvLayout,
                                wf: torch.Tensor, radius: float, *, c_out=None,
                                mean_normalize=False):
    """Launch K5's probe ``probe`` (``noop``, ``planes``, ``mm``); the outputs
    of ``tile_conv_probe_sorted_reference``."""
    res = _launch_k5(params, lay, wf, radius, c_out, mean_normalize, packed=False,
                     probe=_forward_probe(probe))
    launches_probe[probe] += 1
    return res


def tile_conv_probe_sorted_packed_cuda(probe: str, params: MCConvParams, lay: ConvLayout,
                                       wf: torch.Tensor, radius: float, *, c_out=None,
                                       mean_normalize=False):
    """Launch K5p's probe ``probe``; bit-equal to K5's."""
    res = _launch_k5(params, lay, wf, radius, c_out, mean_normalize, packed=True,
                     probe=_forward_probe(probe))
    launches_probe[probe] += 1
    return res


def _forward_probe(probe: str) -> str:
    if probe not in FORWARD_PROBES:
        raise ValueError(f"{probe!r} is not a forward probe ({', '.join(FORWARD_PROBES)})")
    return probe


# ---------------------------------------------------------------- K6: its backward


def _cotangent(lay: ConvLayout, cnt, dout, mean_normalize):
    """``t = s * dout`` on the sorted sample rows, with the forward's per-sample
    factor (``dense_conv._scale``): the cotangent of G's projection."""
    return dout * dense_conv._scale(cnt, lay.smp_valid, mean_normalize)[..., None]


def _wr(params: MCConvParams, C: int, c_out: int):
    """``[W2; b2]`` as ``(C, (H+1) * c_out)``, column ``h * c_out + o``: the
    weights that take the full conv's X (B, rows, H+1, c_out) to d_wf."""
    H = params.w1.shape[1]
    wcat = torch.cat([params.w2.reshape(H, C, c_out), params.b2.reshape(1, C, c_out)])
    return wcat.permute(1, 0, 2).reshape(C, (H + 1) * c_out)


def _backward_walk(params: MCConvParams, lay: ConvLayout, wf, radius, t, c_out):
    """K6's plain arithmetic from the cotangent ``t`` of the sorted sample rows."""
    w1, b1, w2, b2 = params
    H = w1.shape[1]
    B, NP, C = wf.shape
    T = DEFAULT_TILE
    CO = C if c_out is None else c_out
    if c_out is None:
        dG = t[:, :, None, :] * w2  # (B, rows, H, C)
    else:
        dG = (t @ w2.reshape(H * C, c_out).T).reshape(B, -1, H, C)
    r2 = radius_sq(radius)
    r_dev = torch.full((), radius, dtype=wf.dtype, device=wf.device)  # see core/grid.py
    X = wf.new_zeros((B * (NP // T), T, H + 1, CO))
    dw1 = wf.new_zeros((3, H))
    db1 = wf.new_zeros((H,))
    for src_rows, smp_rows, real, tiles in _walk_steps(lay.steps_b, T):
        Sc = src_rows.shape[1]
        p = batched_gather(lay.src, src_rows).reshape(B * Sc, T, 3)
        pv = batched_gather(lay.src_valid, src_rows).reshape(B * Sc, T)
        f = batched_gather(wf, src_rows).reshape(B * Sc, T, C)
        q = batched_gather(lay.smp, smp_rows).reshape(B * Sc, -1, 3)
        qv = (batched_gather(lay.smp_valid, smp_rows) & real).reshape(B * Sc, -1)
        u = batched_gather(t, smp_rows).reshape(B * Sc, -1, CO)
        g = batched_gather(dG, smp_rows).reshape(B * Sc, -1, H, C)
        inr = (pair_d2(q, p) <= r2) & qv[:, :, None] & pv[:, None, :]  # (B*Sc, Q, T)
        off = (p[:, None, :, :] - q[:, :, None, :]) / r_dev
        pre = dense_conv._kernel_preact(off, w1, b1)
        a = torch.cat([torch.relu(pre), torch.ones_like(pre[..., :1])], dim=-1) * inr[..., None]
        X.index_add_(0, tiles, torch.einsum("sqph,sqo->spho", a, u))
        dpre = torch.einsum("sqhc,spc->sqph", g, f)
        dpre = torch.where((pre > 0) & inr[..., None], dpre, 0.0)  # the step at pre == 0 is 0
        dw1 += torch.einsum("sqph,sqpk->kh", dpre, off)
        db1 += dpre.sum(dim=(0, 1, 2))
    X = X.reshape(B, NP, H + 1, CO)
    if c_out is None:
        d_wf = (X[:, :, :H] * w2).sum(dim=2) + X[:, :, H] * b2
        dw2 = (X[:, :, :H] * wf[:, :, None, :]).sum(dim=(0, 1))
        db2 = (X[:, :, H] * wf).sum(dim=(0, 1))
    else:
        Xf = X.reshape(B * NP, (H + 1) * c_out)
        d_wf = (Xf @ _wr(params, C, c_out).T).reshape(B, NP, C)
        dwcat = (wf.reshape(B * NP, C).T @ Xf).reshape(C, H + 1, c_out).transpose(0, 1)
        dw2, db2 = dwcat[:H].reshape(w2.shape), dwcat[H].reshape(b2.shape)
    return d_wf, dw1, db1, dw2, db2


def tile_conv_backward_sorted_reference(params: MCConvParams, lay: ConvLayout,
                                        wf: torch.Tensor, radius: float, cnt: torch.Tensor,
                                        dout: torch.Tensor, *, c_out=None,
                                        mean_normalize=False):
    """Plain version of K6 on the sorted layout.

    From the forward's inputs (``wf`` (B, ntp*T, C) = the sorted weighted
    features), its count and ``dout (B, nts*T, C | c_out)``, returns ``(d_wf,
    dw1 (3, H), db1 (H,), dw2, db2)`` in the shapes of ``MCConvParams``. It
    walks the backward list (source majors x sample minors) as K6 does, and
    forms what the reference's ``_bwd_kernel`` forms: per source row
    ``X[p,h,o] = sum_q a_h(q,p) t[q,o]`` (then d_wf and dW2, db2 from X), and
    per pair ``dpre_h = [pre_h > 0] [in radius] sum_c dG[q,h,c] f~[p,c]``
    (``dG = t . [W2; b2]``), whose sums against the offset (source - sample)
    / r give dW1 and db1."""
    t = _cotangent(lay, cnt, dout, mean_normalize)
    return _backward_walk(params, lay, wf, radius, t, c_out)


def tile_conv_backward_sorted_packed_reference(params: MCConvParams, lay: ConvLayout,
                                               wf: torch.Tensor, radius: float,
                                               cnt: torch.Tensor, dout: torch.Tensor, *,
                                               c_out=None, mean_normalize=False):
    """Plain version of K6p: packs the sample minors' records (positions,
    validity, cotangent) and walks the backward list over them; bit-equal to
    ``tile_conv_backward_sorted_reference``."""
    st = lay.steps_b
    t = _cotangent(lay, cnt, dout, mean_normalize)
    smp, smp_valid, t_m = unpack_minor_records(
        pack_minor_records(lay.smp, lay.smp_valid, t, st.Tm, st.n_minor), st.Tm)
    return _backward_walk(params, lay._replace(smp=smp, smp_valid=smp_valid), wf, radius, t_m,
                          c_out)


def _backward_inputs(name, params, lay, wf, cnt, dout, c_out, mean_normalize):
    """The checked, contiguous operands of K6, K6p and K6v1."""
    w1, b1, w2, b2 = (x.contiguous() for x in params)
    wf = wf.contiguous()
    t = _cotangent(lay, cnt, dout, mean_normalize).contiguous()
    st = lay.steps_b
    if st is None:
        raise ValueError(f"{name}: the layout has no backward list "
                         "(conv_layout(..., backward=True))")
    _build.require_cuda(name, lay.smp, lay.smp_valid, lay.src, lay.src_valid, wf, t, st.j_ids,
                        st.run, w1, b1, w2, b2)
    if any(x.dtype != torch.float32 for x in (lay.smp, lay.src, wf, t, w1, b1, w2, b2)):
        raise TypeError(f"{name}: positions, features, dout and params must be float32")
    B, NS, _ = lay.smp.shape
    NP, C = lay.src.shape[1], wf.shape[-1]
    H = w1.shape[1]
    CO = C if c_out is None else c_out
    if H != dense_conv.HIDDEN or C > dense_conv.MAX_C or CO > dense_conv.MAX_C:
        raise NotImplementedError(f"{name} is built for H={dense_conv.HIDDEN} and "
                                  f"C<={dense_conv.MAX_C}; got H={H}, C={C}, c_out={c_out}")
    if tuple(t.shape) != (B, NS, CO) or tuple(wf.shape) != (B, NP, C):
        raise ValueError(f"{name}: dout {tuple(t.shape)} / wf {tuple(wf.shape)} do not match "
                         "the layout")
    _check_minor(name, st.Tm)
    return MCConvParams(w1, b1, w2, b2), wf, t, st


def _launch_k6(params: MCConvParams, lay: ConvLayout, wf, radius, cnt, dout, c_out,
               mean_normalize, packed: bool, noop: bool = False, parts: bool = False):
    """K6 or, with ``packed``, K6p on the sorted layout; with ``noop``, its
    bwd_noop probe. With ``parts``, the kernel's own outputs ``(out, w1part,
    w2part)`` (``out`` is X at the full site, d_wf at the depthwise ones)
    before the partial sums are reduced."""
    name = ("tile_conv_backward (K6p" if packed else "tile_conv_backward (K6") + (
        " bwd_noop)" if noop else ")")
    (w1, b1, w2, b2), wf, t, st = _backward_inputs(name, params, lay, wf, cnt, dout, c_out,
                                                   mean_normalize)
    B, NS, _ = lay.smp.shape
    NP, C = lay.src.shape[1], wf.shape[-1]
    H = w1.shape[1]
    H1 = H + 1
    CO = C if c_out is None else c_out
    ntp = NP // DEFAULT_TILE
    dev = wf.device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    lib = _build.library()
    stream = _build.stream_of(wf)
    depthwise = c_out is None
    n_w1, n_w2, passes = (lib.tile_conv_bwd_blocks(B, ntp, C, CO, what) for what in range(3))
    w1part = dense_conv.partials(n_w1, 4 * H, dev)
    xs = None
    if depthwise:
        dG, out, w2part = t, empty(B, NP, C), dense_conv.partials(n_w2, H1 * C, dev)
        if passes > 1:  # X between a block's contractions
            xs = empty(B, NP, H1, C)
    else:
        dG, out, w2part = empty(B, NS, H1, C), empty(B, NP, H1, CO), w1part
        dense_conv.dg_full(t, w2, b2, B * NS, CO, H * C, H1 * C, dG,
                           f"mcconv_bwd_dg_full_kernel ({name} dG)")
    head = (_build.ptr(lay.src), _build.ptr(lay.src_valid), _build.ptr(wf))
    rest = (_build.ptr(dG), _build.ptr(st.j_ids), _build.ptr(st.run), _build.ptr(w1),
            _build.ptr(b1), _build.ptr(w2), _build.ptr(b2), B, NS, NP, C, CO, H,
            st.j_ids.shape[2], st.j_ids.shape[1], ntp, st.n_minor, st.Tm, radius_sq(radius),
            float(radius), int(depthwise), _build.ptr(out),
            None if xs is None else _build.ptr(xs), _build.ptr(w1part), _build.ptr(w2part),
            stream)
    if packed:
        rec = pack_minor_records(lay.smp, lay.smp_valid, t, st.Tm, st.n_minor)
        launch = lib.tile_conv_bwd_packed_noop_launch if noop else lib.tile_conv_bwd_packed_launch
        err = launch(_build.ptr(rec), *head, *rest)
    else:
        launch = lib.tile_conv_bwd_noop_launch if noop else lib.tile_conv_bwd_launch
        err = launch(_build.ptr(lay.smp), _build.ptr(lay.smp_valid), *head, _build.ptr(t), *rest)
    _build.check(err, ("tile_conv_bwd_packed_kernel" if packed else "tile_conv_bwd_kernel")
                 + (" (bwd_noop probe)" if noop else ""))
    if parts:
        return out, w1part, w2part
    return source_grads(MCConvParams(w1, b1, w2, b2), wf, out, w1part, w2part, c_out, name)


def source_grads(params: MCConvParams, wf, out, w1part, w2part, c_out, name: str):
    """The gradients ``(d_wf, dw1, db1, dw2, db2)`` from what K6 or K10
    wrote: its partial sums of [dW1; db1] and ([dW2; db2], depthwise) summed
    in row order by K2's reduction kernel; ``out`` is d_wf at a depthwise
    site, and at the full site X, from which K2's two GEMMs form d_wf = X .
    Wr^T and [dW2; db2] = wf^T X."""
    w1, b1, w2, b2 = params
    B, NP, C = wf.shape
    H = w1.shape[1]
    H1 = H + 1
    lib = _build.library()
    stream = _build.stream_of(wf)
    w1b1 = dense_conv.ordered_sum(w1part, lib, stream,
                                  f"mcconv_bwd_reduce_kernel ({name} dW1, db1)").reshape(4, H)
    if c_out is None:
        d_wf = out
        dwcat = dense_conv.ordered_sum(w2part, lib, stream,
                                       f"mcconv_bwd_reduce_kernel ({name} dW2, db2)")
        dwcat = dwcat.reshape(H1, C)
    else:
        R, K = B * NP, H1 * c_out
        wr = _wr(params, C, c_out).contiguous()
        d_wf = torch.empty((B, NP, C), dtype=torch.float32, device=wf.device)
        dense_conv.dg_full(out, wr, wr, R, K, C, C, d_wf,
                           f"mcconv_bwd_dg_full_kernel ({name} d_wf)")
        dwcat = dense_conv.wcat_grad(wf, out, R, C, K).reshape(C, H1, c_out).transpose(0, 1)
    return d_wf, w1b1[:3], w1b1[3], *dense_conv._split_wcat(dwcat, H, C, c_out, w2, b2)


def tile_conv_backward_sorted_cuda(params: MCConvParams, lay: ConvLayout, wf: torch.Tensor,
                                   radius: float, cnt: torch.Tensor, dout: torch.Tensor, *,
                                   c_out=None, mean_normalize=False):
    """Launch K6 on CUDA tensors; the arguments and outputs of the plain version."""
    global backward_launches
    res = _launch_k6(params, lay, wf, radius, cnt, dout, c_out, mean_normalize, packed=False)
    backward_launches += 1
    return res


def tile_conv_backward_sorted_packed_cuda(params: MCConvParams, lay: ConvLayout,
                                          wf: torch.Tensor, radius: float, cnt: torch.Tensor,
                                          dout: torch.Tensor, *, c_out=None,
                                          mean_normalize=False):
    """Launch K6p (K6 over packed sample records); bit-equal to K6."""
    global packed_backward_launches
    res = _launch_k6(params, lay, wf, radius, cnt, dout, c_out, mean_normalize, packed=True)
    packed_backward_launches += 1
    return res


def tile_conv_backward_noop_sorted_reference(params: MCConvParams, lay: ConvLayout,
                                             wf: torch.Tensor, radius: float, cnt: torch.Tensor,
                                             dout: torch.Tensor, *, c_out=None,
                                             mean_normalize=False):
    """Plain version of the bwd_noop probe of K6 and K6p: every gradient 0
    (``tile_conv.py:718-726``), in the shapes of K6's."""
    p = params
    return (torch.zeros_like(wf), torch.zeros_like(p.w1), torch.zeros_like(p.b1),
            torch.zeros_like(p.w2), torch.zeros_like(p.b2))


def tile_conv_backward_noop_sorted_cuda(params: MCConvParams, lay: ConvLayout, wf: torch.Tensor,
                                        radius: float, cnt: torch.Tensor, dout: torch.Tensor, *,
                                        c_out=None, mean_normalize=False):
    """Launch K6's bwd_noop probe; the outputs of its plain version."""
    global backward_launches_probe
    res = _launch_k6(params, lay, wf, radius, cnt, dout, c_out, mean_normalize, packed=False,
                     noop=True)
    backward_launches_probe += 1
    return res


def tile_conv_backward_noop_sorted_packed_cuda(params: MCConvParams, lay: ConvLayout,
                                               wf: torch.Tensor, radius: float,
                                               cnt: torch.Tensor, dout: torch.Tensor, *,
                                               c_out=None, mean_normalize=False):
    """Launch K6p's bwd_noop probe; the outputs of its plain version."""
    global backward_launches_probe
    res = _launch_k6(params, lay, wf, radius, cnt, dout, c_out, mean_normalize, packed=True,
                     noop=True)
    backward_launches_probe += 1
    return res


# ---------------------------------------------------------------- K6v1: the per-h backward


def _stacked_w2(params: MCConvParams, C: int, c_out):
    """``[W2; b2]`` as (H+1, C) depthwise, (H+1, C, c_out) full."""
    H = params.w1.shape[1]
    if c_out is None:
        return torch.cat([params.w2, params.b2[None]])
    return torch.cat([params.w2.reshape(H, C, c_out), params.b2.reshape(1, C, c_out)])


def tile_conv_backward_v1_sorted_reference(params: MCConvParams, lay: ConvLayout,
                                           wf: torch.Tensor, radius: float, cnt: torch.Tensor,
                                           dout: torch.Tensor, *, c_out=None,
                                           mean_normalize=False):
    """Plain version of K6v1: K6's gradients in the reference's v1 form
    (``_bwd_kernel_v1``, ``tile_conv.py:825``), walking the backward list per
    h. With ``t`` the cotangent and ``t_h = t * W2_h`` (depthwise) or ``t .
    W2_h^T`` (full; ``h = H`` takes b2), per step: ``d_f~ += a_h^T t_h``,
    ``g_h = a_h f~`` over the step's sources and ``dW2_h += sum_q t g_h``
    over its sample rows, and ``dpre = (t_h f~^T) [pre_h > 0]`` into dW1 and
    db1."""
    w1, b1 = params.w1, params.b1
    H = w1.shape[1]
    B, NP, C = wf.shape
    T = DEFAULT_TILE
    CO = C if c_out is None else c_out
    t = _cotangent(lay, cnt, dout, mean_normalize)
    wcat = _stacked_w2(params, C, c_out)
    th = (t[:, :, None, :] * wcat if c_out is None else
          torch.einsum("bqo,hco->bqhc", t, wcat))  # (B, rows, H+1, C)
    r2 = radius_sq(radius)
    r_dev = torch.full((), radius, dtype=wf.dtype, device=wf.device)
    d_wf = wf.new_zeros((B * (NP // T), T, C))
    dw1 = wf.new_zeros((3, H))
    db1 = wf.new_zeros((H,))
    dwcat = wf.new_zeros(wcat.shape)
    for src_rows, smp_rows, real, tiles in _walk_steps(lay.steps_b, T):
        Sc = src_rows.shape[1]
        p = batched_gather(lay.src, src_rows).reshape(B * Sc, T, 3)
        pv = batched_gather(lay.src_valid, src_rows).reshape(B * Sc, T)
        f = batched_gather(wf, src_rows).reshape(B * Sc, T, C)
        q = batched_gather(lay.smp, smp_rows).reshape(B * Sc, -1, 3)
        qv = (batched_gather(lay.smp_valid, smp_rows) & real).reshape(B * Sc, -1)
        u = batched_gather(t, smp_rows).reshape(B * Sc, -1, CO)
        tq = batched_gather(th, smp_rows).reshape(B * Sc, -1, H + 1, C)
        inr = (pair_d2(q, p) <= r2) & qv[:, :, None] & pv[:, None, :]  # (B*Sc, Q, T)
        off = (p[:, None, :, :] - q[:, :, None, :]) / r_dev
        pre = dense_conv._kernel_preact(off, w1, b1)
        for h in range(H + 1):
            a_h = (torch.relu(pre[..., h]) if h < H else torch.ones_like(pre[..., 0])) * inr
            t_h = tq[:, :, h]
            d_wf.index_add_(0, tiles, torch.einsum("sqp,sqc->spc", a_h, t_h))
            g_h = torch.einsum("sqp,spc->sqc", a_h, f)
            dwcat[h] += ((u * g_h).sum(dim=(0, 1)) if c_out is None else
                         torch.einsum("sqc,sqo->co", g_h, u))
            if h < H:
                dpre = torch.einsum("sqc,spc->sqp", t_h, f)
                dpre = torch.where((pre[..., h] > 0) & inr, dpre, 0.0)
                dw1[:, h] += torch.einsum("sqp,sqpk->k", dpre, off)
                db1[h] += dpre.sum()
    d_wf = d_wf.reshape(B, NP, C)
    return d_wf, dw1, db1, *dense_conv._split_wcat(dwcat, H, C, c_out, params.w2, params.b2)


def tile_conv_backward_v1_sorted_cuda(params: MCConvParams, lay: ConvLayout, wf: torch.Tensor,
                                      radius: float, cnt: torch.Tensor, dout: torch.Tensor, *,
                                      c_out=None, mean_normalize=False):
    """Launch K6v1 on CUDA tensors; the arguments and outputs of the plain
    version. The full conv's ``t_h`` comes from K2's dG GEMM, as in K6."""
    global backward_v1_launches
    name = "tile_conv_backward_v1 (K6v1)"
    (w1, b1, w2, b2), wf, t, st = _backward_inputs(name, params, lay, wf, cnt, dout, c_out,
                                                   mean_normalize)
    B, NS, _ = lay.smp.shape
    NP, C = lay.src.shape[1], wf.shape[-1]
    H = w1.shape[1]
    H1 = H + 1
    CO = C if c_out is None else c_out
    ntp = NP // DEFAULT_TILE
    CB = min(C, TILE_BWD_CHANNELS)
    nb = -(-C // CB)
    depthwise = c_out is None
    width = H1 * C * (1 if depthwise else CO)  # floats of a source tile's [dW2; db2] partial
    if B * ntp * width > _V1_PARTIAL_FLOATS:
        raise NotImplementedError(f"{name}: the dW2 partials of {B * ntp} source tiles x "
                                  f"{width} floats pass {_V1_PARTIAL_FLOATS}")
    dev = wf.device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    lib = _build.library()
    stream = _build.stream_of(wf)
    dG = t
    if not depthwise:
        dG = empty(B, NS, H1, C)
        dense_conv.dg_full(t, w2, b2, B * NS, CO, H * C, H1 * C, dG,
                           f"mcconv_bwd_dg_full_kernel ({name} t_h)")
    d_wf, w1part, w2part = empty(B, NP, C), empty(B * ntp * nb, 4, H), empty(B * ntp, width)
    err = lib.tile_conv_bwd_v1_launch(
        _build.ptr(lay.smp), _build.ptr(lay.smp_valid), _build.ptr(lay.src),
        _build.ptr(lay.src_valid), _build.ptr(wf), _build.ptr(t), _build.ptr(dG),
        _build.ptr(st.j_ids), _build.ptr(st.run), _build.ptr(w1), _build.ptr(b1),
        _build.ptr(w2), _build.ptr(b2), B, NS, NP, C, CO, CB, H, st.j_ids.shape[2],
        st.j_ids.shape[1], ntp, st.n_minor, st.Tm, radius_sq(radius), float(radius),
        int(depthwise), _build.ptr(d_wf), _build.ptr(w1part), _build.ptr(w2part), stream,
    )
    _build.check(err, "tile_conv_bwd_v1_kernel")
    w1b1, dwcat = empty(4, H), empty(width)
    for part, rows, n, dst, what in ((w1part, B * ntp * nb, 4 * H, w1b1, "dW1, db1"),
                                     (w2part, B * ntp, width, dwcat, "dW2, db2")):
        err = lib.mcconv_bwd_reduce_launch(_build.ptr(part), rows, n, _build.ptr(dst), stream)
        _build.check(err, f"mcconv_bwd_reduce_kernel ({name} {what})")
    dwcat = dwcat.reshape(H1, C) if depthwise else dwcat
    backward_v1_launches += 1
    return d_wf, w1b1[:3], w1b1[3], *dense_conv._split_wcat(dwcat, H, C, c_out, w2, b2)


# ---------------------------------------------------------------- routing


def conv_variant(lay: ConvLayout) -> tuple[bool, bool]:
    """``(packed, v1)``: the switches' choice of the conv's kernels
    (``tile_conv.py:1354-1362``, ``:1036``). Packed records only without
    ``MCCNN_TILE_BWD_V1=1`` and at an even minor; then K5p and K6p, with v1
    K5 and K6v1, else K5 and K6."""
    return _PACK and not _BWD_V1 and lay.steps.Tm % 2 == 0, _BWD_V1


def checked_probe() -> str:
    """``_PROBE`` if it is empty or one of the reference's four probes; any
    other value raises (the reference would run the conv, ROADMAP queue 3)."""
    if _PROBE and _PROBE not in (*FORWARD_PROBES, *BACKWARD_PROBES):
        raise ValueError(f"MCCNN_TILE_PROBE={_PROBE!r} is not a probe: "
                         f"{', '.join((*FORWARD_PROBES, *BACKWARD_PROBES))} or unset")
    return _PROBE


_FORWARDS = {(False, "cpu"): tile_conv_sorted_reference, (False, "cuda"): tile_conv_sorted_cuda,
             (True, "cpu"): tile_conv_sorted_packed_reference,
             (True, "cuda"): tile_conv_sorted_packed_cuda}
_PROBE_FORWARDS = {(False, "cpu"): tile_conv_probe_sorted_reference,
                   (False, "cuda"): tile_conv_probe_sorted_cuda,
                   (True, "cpu"): tile_conv_probe_sorted_reference,
                   (True, "cuda"): tile_conv_probe_sorted_packed_cuda}
_BACKWARDS = {
    ("K6 bwd_noop", "cpu"): tile_conv_backward_noop_sorted_reference,
    ("K6 bwd_noop", "cuda"): tile_conv_backward_noop_sorted_cuda,
    ("K6p bwd_noop", "cpu"): tile_conv_backward_noop_sorted_reference,
    ("K6p bwd_noop", "cuda"): tile_conv_backward_noop_sorted_packed_cuda,
    ("K6", "cpu"): tile_conv_backward_sorted_reference,
    ("K6", "cuda"): tile_conv_backward_sorted_cuda,
    ("K6p", "cpu"): tile_conv_backward_sorted_packed_reference,
    ("K6p", "cuda"): tile_conv_backward_sorted_packed_cuda,
    ("K6v1", "cpu"): tile_conv_backward_v1_sorted_reference,
    ("K6v1", "cuda"): tile_conv_backward_v1_sorted_cuda,
}


def _device_kind(t: torch.Tensor) -> str:
    return "cpu" if t.device.type == "cpu" else "cuda"


class TileMCConvFunction(torch.autograd.Function):
    """``(w1, b1, w2, b2, wf) -> out`` on the sorted layout: K5 forward and K6
    backward on CUDA tensors, their plain versions on CPU tensors; K5p / K6p
    or K6v1 as ``conv_variant`` picks. ``wf`` is the sorted ``features /
    pdf``; positions and pdf get no gradient here, as the reference's
    ``_core_bwd`` returns zeros for them. Under a probe (``checked_probe``)
    the forward runs the probe of its kernel (noop, planes, mm) and the
    backward K6's or K6p's bwd_noop; K6v1 takes none."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, wf, lay, radius, c_out, mean_normalize):
        packed, v1 = conv_variant(lay)
        probe = checked_probe()
        params = MCConvParams(w1, b1, w2, b2)
        kw = dict(c_out=c_out, mean_normalize=mean_normalize)
        if probe in FORWARD_PROBES:
            out, cnt = _PROBE_FORWARDS[packed, _device_kind(wf)](probe, params, lay, wf, radius,
                                                                  **kw)
        else:
            out, cnt = _FORWARDS[packed, _device_kind(wf)](params, lay, wf, radius, **kw)
        ctx.save_for_backward(w1, b1, w2, b2, wf, cnt)
        ctx.lay = lay
        ctx.conv = (radius, c_out, mean_normalize)
        kernel = "K6p" if packed else "K6"
        ctx.backward_kernel = ("K6v1" if v1 else
                               f"{kernel} bwd_noop" if probe in BACKWARD_PROBES else kernel)
        return out

    @staticmethod
    def backward(ctx, dout):
        w1, b1, w2, b2, wf, cnt = ctx.saved_tensors
        radius, c_out, mean = ctx.conv
        bwd = _BACKWARDS[ctx.backward_kernel, _device_kind(wf)]
        d_wf, dw1, db1, dw2, db2 = bwd(MCConvParams(w1, b1, w2, b2), ctx.lay, wf, radius, cnt,
                                       dout.contiguous(), c_out=c_out, mean_normalize=mean)
        return dw1, db1, dw2, db2, d_wf, None, None, None, None


def _unsort(rows_sorted, order):
    """Rows in curve order (B, >= N, F) -> the caller's order (B, N, F)."""
    B, N = order.shape
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(N, device=order.device).expand(B, N).contiguous())
    return torch.gather(rows_sorted, 1, inv[..., None].expand(B, N, rows_sorted.shape[-1]))


def tile_mc_conv(params: MCConvParams, sample_pts, sample_mask, src_pts, src_mask, features,
                 pdf, radius: float, *, max_pairs: int, max_steps: int | None = None,
                 c_out: int | None = None, mean_normalize: bool = False,
                 with_overflow: bool = False):
    """Monte-Carlo conv over Hilbert tile pairs (``tile_conv.py:1207``): every
    valid in-radius source that the step list reaches contributes. Returns
    ``out (B, M, C | c_out)`` and, with ``with_overflow``, the (B,) dropped
    step count (nonzero means missing neighbours: raise the budget). It runs
    ``TileMCConvFunction``: K5 and K6 on CUDA tensors, their plain versions on
    CPU tensors. The backward list is built only when a gradient is wanted
    (evaluation does not pay for it). Under ``MCCNN_TILE_PROBE`` it runs the
    probes (``checked_probe``), whose values are not the conv's."""
    checked_probe()
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (*params, features, pdf))
    lay = conv_layout(sample_pts, sample_mask, src_pts, src_mask, radius,
                      max_pairs=max_pairs, max_steps=max_steps, backward=grad)
    wf = _sorted_weighted_features(lay, features, pdf)
    out_sorted = TileMCConvFunction.apply(*params, wf, lay, float(radius), c_out,
                                          mean_normalize)
    out = _unsort(out_sorted, lay.order_s)
    out = torch.where(sample_mask[..., None], out, 0.0)
    return (out, lay.overflow) if with_overflow else out


# ---------------------------------------------------------------- K7 and K8


class SelfLayout(NamedTuple):
    """One point set against itself: sorted rows, the step list, its overflow."""

    order: torch.Tensor  # (B, N)
    pts: torch.Tensor  # (B, nt*T, 3) sorted positions (invalid rows 0)
    valid: torch.Tensor  # (B, nt*T)
    steps: StepList  # sample majors (T) x candidate minors (Tm) of the same rows
    S: int
    overflow: torch.Tensor  # (B,)


def self_adjacency(points, mask, radius: float, order: torch.Tensor):
    """One point set against itself in ``order``: the sorted rows (B, nt*T, 3),
    their validity and the refined sample-tile (T) x candidate-minor (Tm)
    adjacency (B, nt, nt_m)."""
    T = DEFAULT_TILE
    Tm = tile_minor(T)
    N = points.shape[1]
    nt, nt_m = -(-N // T), -(-N // Tm)
    p, v = _sorted_rows(points, mask, order, nt * T)
    mn, mx = _tile_boxes(p, v, T)
    mn_m, mx_m = _tile_boxes(p[:, : nt_m * Tm], v[:, : nt_m * Tm], Tm)
    return p, v, _refined_adjacency(p, v, mn, mx, p, v, mn_m, mx_m, T, radius, Tm)


def count_self_steps(points, mask, radius: float, order: torch.Tensor,
                     chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(B,) chunked-step demand of one point set against itself in ``order``."""
    _, _, adj = self_adjacency(points, mask, radius, order)
    return _needed_steps(adj, chunk * (DEFAULT_TILE // tile_minor()))


def self_layout(points, mask, radius: float, *, max_pairs: int, max_steps: int | None = None,
                chunk: int = DEFAULT_CHUNK, order: torch.Tensor | None = None) -> SelfLayout:
    """The layout of ``tile_kde`` and ``make_cover_sweep`` (``:1470-1483``,
    ``:1676-1697``)."""
    if order is None:
        order = curve_order(points, mask)
    p, v, adj = self_adjacency(points, mask, radius, order)
    nt, nt_m = adj.shape[1], adj.shape[2]
    Tm = tile_minor()
    Gm = chunk * (DEFAULT_TILE // Tm)
    S = _steps_for_pairs(min(max_pairs, nt * nt_m), Gm, nt, nt_m)
    if max_steps is not None:
        S = min(S, max(int(max_steps), 1))
    steps = _step_list(adj, S, Gm, Tm)
    return SelfLayout(order, p.contiguous(), v.contiguous(), steps, S,
                      (steps.need - S).clamp_min(0))


def _self_sums_reference(lay: SelfLayout, radius: float, weigh, dtype, flags=None):
    """Per sorted row, the sum of ``weigh(d2, in_radius)`` over the candidates
    the step list reaches (only ``flags`` rows when given); 0 on invalid rows."""
    B, NR, _ = lay.pts.shape
    T = DEFAULT_TILE
    r2 = radius_sq(radius)
    acc = torch.zeros((B * (NR // T), T), dtype=dtype, device=lay.pts.device)
    for smp_rows, cand_rows, real, tiles in _walk_steps(lay.steps, T):
        Sc = smp_rows.shape[1]
        q = batched_gather(lay.pts, smp_rows).reshape(B * Sc, T, 3)
        p = batched_gather(lay.pts, cand_rows).reshape(B * Sc, -1, 3)
        pv = batched_gather(lay.valid, cand_rows) & real
        if flags is not None:
            pv = pv & batched_gather(flags, cand_rows)
        d2 = pair_d2(q, p)
        acc.index_add_(0, tiles, weigh(d2, (d2 <= r2) & pv.reshape(B * Sc, 1, -1)))
    acc = acc.reshape(B, NR)
    return torch.where(lay.valid, acc, torch.zeros_like(acc))


def _kde_constants(radius: float, kde_window: float):
    h = kde_window * float(radius)
    return -0.5 / (h * h), 1.0 / ((h**3) * (2.0 * math.pi) ** 1.5)


def tile_kde_sums_reference(lay: SelfLayout, radius: float, kde_window: float = 0.25):
    """Plain version of K7: per sorted row, the unnormalised kernel sum."""
    neg_half_inv_h2, _ = _kde_constants(radius, kde_window)

    def weigh(d2, inr):
        return torch.where(inr, torch.exp(d2.clamp_min(0.0) * neg_half_inv_h2), 0.0).sum(-1)

    return _self_sums_reference(lay, radius, weigh, torch.float32)


def tile_kde_sums_cuda(lay: SelfLayout, radius: float, kde_window: float = 0.25):
    """Launch K7; the output of the plain version."""
    global kde_launches
    st = lay.steps
    _build.require_cuda("tile_kde (K7)", lay.pts, lay.valid, st.j_ids, st.run)
    _check_minor("tile_kde (K7)", st.Tm)
    B, NR, _ = lay.pts.shape
    neg_half_inv_h2, _ = _kde_constants(radius, kde_window)
    out = torch.empty((B, NR), dtype=torch.float32, device=lay.pts.device)
    lib = _build.library()
    err = lib.tile_kde_launch(
        _build.ptr(lay.pts), _build.ptr(lay.valid), _build.ptr(st.j_ids), _build.ptr(st.run),
        B, NR, st.j_ids.shape[2], st.j_ids.shape[1], st.n_minor, st.Tm, radius_sq(radius),
        neg_half_inv_h2, _build.ptr(out), _build.stream_of(lay.pts),
    )
    _build.check(err, "tile_kde_kernel")
    kde_launches += 1
    return out


def tile_kde(points, mask, radius: float, *, max_pairs: int, max_steps: int | None = None,
             kde_window: float = 0.25, with_overflow: bool = False):
    """Exact Gaussian-KDE density over tile pairs (``tile_conv.py:1436``): the
    dense KDE's estimator, every in-radius neighbour the step list reaches,
    masked points 1. CPU -> plain version, CUDA -> K7."""
    lay = self_layout(points, mask, radius, max_pairs=max_pairs, max_steps=max_steps)
    sums = (tile_kde_sums_reference if points.device.type == "cpu" else
            tile_kde_sums_cuda)(lay, radius, kde_window)
    _, norm = _kde_constants(radius, kde_window)
    dens = _unsort((norm * sums)[..., None], lay.order)[..., 0]
    out = torch.where(mask, dens, 1.0)
    return (out, lay.overflow) if with_overflow else out


def cover_counts_reference(lay: SelfLayout, flags: torch.Tensor, radius: float):
    """Plain version of K8: per sorted row, the flagged valid candidates within
    the radius (int32), 0 on invalid rows."""

    def weigh(_d2, inr):
        return inr.sum(-1).to(torch.int32)

    return _self_sums_reference(lay, radius, weigh, torch.int32, flags)


def cover_counts_cuda(lay: SelfLayout, flags: torch.Tensor, radius: float):
    """Launch K8; the output of the plain version."""
    global cover_launches
    st = lay.steps
    flags = flags.contiguous()
    _build.require_cuda("cover_counts (K8)", lay.pts, lay.valid, flags, st.j_ids, st.run)
    if flags.dtype != torch.bool:
        raise TypeError("cover_counts (K8): flags must be bool")
    _check_minor("cover_counts (K8)", st.Tm)
    B, NR, _ = lay.pts.shape
    out = torch.empty((B, NR), dtype=torch.int32, device=lay.pts.device)
    lib = _build.library()
    err = lib.tile_cover_launch(
        _build.ptr(lay.pts), _build.ptr(lay.valid), _build.ptr(flags), _build.ptr(st.j_ids),
        _build.ptr(st.run), B, NR, st.j_ids.shape[2], st.j_ids.shape[1], st.n_minor, st.Tm,
        radius_sq(radius), _build.ptr(out), _build.stream_of(lay.pts),
    )
    _build.check(err, "tile_cover_kernel")
    cover_launches += 1
    return out


class TileCoverSweep(NamedTuple):
    """Reusable tile machinery for the 27 cover queries of one point set
    (``tile_conv.py:1565``): build once with ``make_cover_sweep``."""

    layout: SelfLayout
    radius: float

    @property
    def valid(self):
        return self.layout.valid

    @property
    def overflow(self):
        return self.layout.overflow

    def counts(self, flags: torch.Tensor) -> torch.Tensor:
        """flags (B, nt*T) bool over SORTED rows -> in-radius flagged-neighbour
        counts (B, nt*T) int32, self included. CPU -> plain, CUDA -> K8."""
        if flags.device.type == "cpu":
            return cover_counts_reference(self.layout, flags, self.radius)
        return cover_counts_cuda(self.layout, flags, self.radius)


def make_cover_sweep(points, mask, radius: float, *, max_pairs: int,
                     max_steps: int | None = None, order: torch.Tensor | None = None
                     ) -> TileCoverSweep:
    """``order`` overrides the curve order (the sampler passes its cell-Hilbert
    order); the chunk is ``DEFAULT_COVER_CHUNK`` (``:1654``)."""
    lay = self_layout(points, mask, radius, max_pairs=max_pairs, max_steps=max_steps,
                      chunk=DEFAULT_COVER_CHUNK, order=order)
    return TileCoverSweep(lay, float(radius))
