"""K1 and K2 with this checkout's pair kernels against another checkout's, on
the same inputs in one process on the card; with ``--v1``, K1v1 and K2v1;
with ``--planes``, K1p.

    python -m mccnn_tpu_torch.tools.dense_ab OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --v1 OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --planes OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --same OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --t1 OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --tile-bwd OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --bucket-bwd OTHER_CHECKOUT

The other checkout's kernel library is built there (its own
``ops/cuda/_build.py``, in a child process) and loaded beside this one's.
K1 and K2 are composed of one library's pair kernel, projection and dG GEMM
(``OTHER_SIGNATURES``: the other's take no split partials, and its K2 reads
a depthwise dG that an elementwise kernel formed) and this checkout's dW2
GEMM and reductions, whose code both share. The other's K2
partial count comes from ``mcconv_bwd_pair_blocks(N, M, C)`` a cloud
(``OTHER_BLOCKS``), this checkout's from ``(B, N, M, C)`` for the batch.

At MCClassS's three sites (B = 32 clouds of 1024 points, grow 128) and
ShapeNet's three 1024 -> 1024 sites (B = 32, grow 64, the
``tasks.shapenet --synthetic`` data) it prints, per site: whether G, the
counts and d_f~ are bit-equal between the two, the largest difference of
dW1 / db1 (their partial sums are taken in another order), and the time of
each K1 and K2, of each pair kernel alone (CUDA events, warm, best of
several runs, taken in the order other, this, this, other) and of each
one's GEMM parts, K1's projection and K2's dG / dW2 GEMMs. The outputs
differ where this checkout splits a GEMM's reduction (``out_rel_diff``).
With ``--v1`` it runs this checkout's K1v1 / K2v1 (``dense_conv``'s
wrappers) against the other checkout's ``mcconv_v1_fwd_launch`` /
``mcconv_v1_bwd_launch`` (``OTHER_V1_SIGNATURES``: the single-launch K2v1
with per-block [dW2; db2] partials, sized as its wrapper sized them and
reduced by this checkout's reduction kernel) at the 14 dense sites of
MCClass and MCClassH (``ZOO_SITES``, B = 32), and prints per site whether
the counts and K1v1's ``out`` are bit-equal, the largest relative
difference of ``out`` and of each K2v1 gradient, and both checkouts' times
of each kernel (order other, this, this, other), then their sums. With
``--planes`` it runs this checkout's K1p (``dense_conv``'s wrapper) against
the other checkout's ``mcconv_planes_pair_launch`` (``OTHER_PLANES_SIGNATURES``:
the all-pairs K1p, which takes no scratch) followed by this checkout's
projection, at the zoo's 14 sites and MCClassS's 3 (B = 32), and prints per
site whether the counts and G are bit-equal (G's largest relative
difference where not), both checkouts' K1p times and this checkout's K1
time, then their sums. With ``--same`` (for another checkout whose library
has this checkout's dense entry points and arguments) it runs this
checkout's K1 / K2, K1v1 / K2v1 and K1p wrappers on each library, at the
zoo's 14 sites, MCClassS's 3 and ShapeNet's 3 (B = 32), and prints per site
whether every output is bit-equal. With ``--t1`` (for another checkout whose
``dense_probe_launch`` has this checkout's arguments) it runs T1 noop,
mm_only and mm_big through this checkout's wrapper on each library at
``tools.dense_breakdown``'s inputs, the features given in bf16 (the kernels
alone), and prints for each whether the outputs are bit-equal and both
libraries' call and device times (``best_ms``, ``device_ms``; order other,
this, this, other).

With ``--tile-bwd`` it runs K6 and with ``--bucket-bwd`` K10, the tile and
bucket MC-conv backwards, on both libraries at ``chip_smoke.py``'s sites:
ScanNet's MCSeg on a block batch of 8 x 8192 points at its four tile sites
(stem, enc_0_1, dec_2_1, dec_1_0: ``SEG_SITES``) with a tile capacity, and
without one at the same four bucket sites and MCClassS's conv_0_1 at B = 32
x 4096 (``MODELNET_SITE``). The other checkout's ``tile_conv_bwd_launch`` /
``bucket_conv_bwd_launch`` are called with their own arguments and partial
sums (``OTHER_TILE_SIGNATURES``, ``OTHER_BUCKET_SIGNATURES``: the kernels of
a 16-channel block grid, K10 over chunks of up to 128 slots of a cell, as
their wrappers sized them), this checkout's through its wrappers; both
kernels' partials are reduced, and the full site's X projected, by this
checkout's reduction kernel and GEMMs (``tile_conv.source_grads``). Per site
it prints whether the kernel's own output is bit-equal (X at the full site,
d_f~ at the depthwise ones), the largest relative difference of each
parameter gradient, and both libraries' device times (``device_ms``, order
other, this, this, other) of the kernel (with its dG GEMM at the full site
and its zeroed partials) and of the whole backward, then their sums.

It refuses to run without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

H = 8
SEED = 0
B = 32
SHAPENET_RADII, SHAPENET_PARTS, SHAPENET_CATS = (0.025, 0.1, 0.4), 4, 16

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OTHER_SIGNATURES = {
    "mcconv_pair_launch": [P] * 7 + [I] * 5 + [F, F] + [P] * 3,
    "mcconv_bwd_pair_launch": [P] * 8 + [I] * 5 + [F, F] + [P] * 3,
    "mcconv_project_full_launch": [P] * 4 + [I] * 4 + [P] * 2,
    "mcconv_bwd_dg_full_launch": [P] * 3 + [I] * 4 + [P] * 2,
    "mcconv_bwd_dg_depthwise_launch": [P] * 3 + [I] * 3 + [P] * 2,
}
OTHER_BLOCKS = [I, I, I]  # mcconv_bwd_pair_blocks(N, M, C): partial rows a cloud
OTHER_V1_SIGNATURES = {
    "mcconv_v1_fwd_launch": [P] * 9 + [I] * 7 + [F, F] + [P] * 3,
    "mcconv_v1_bwd_tiles": [I] * 4,
    "mcconv_v1_bwd_launch": [P] * 11 + [I] * 7 + [F, F, I] + [P] * 4,
}
OTHER_PLANES_SIGNATURES = {"mcconv_planes_pair_launch": [P] * 7 + [I] * 5 + [F, F] + [P] * 3}
# The other K6 / K10: one block per (cloud, source tile or cell chunk, block
# of OTHER_CB channels), K10's chunks of up to OTHER_SLOTS slots of a cell.
OTHER_TILE_SIGNATURES = {"tile_conv_bwd_launch": [P] * 13 + [I] * 12 + [F, F, I] + [P] * 4}
OTHER_BUCKET_SIGNATURES = {"bucket_conv_bwd_launch": [P] * 13 + [I] * 12 + [F, F, I] + [P] * 4}
OTHER_CB, OTHER_SLOTS = 16, 128
# The other K2v1's partials: at most this many blocks, and floats in all.
OTHER_V1_BLOCKS, OTHER_V1_PARTIAL_FLOATS = 264, 64 << 20

RADII_3, RADII_2 = (0.1, 0.2, 0.4), (0.1, 0.4)
# ScanNet's MCSeg at the CLI's defaults on a block batch (as chip_smoke.py):
# its four big conv sites (name, in level, out level, radius, C, CO), each
# the tile conv's with a tile capacity and the bucket conv's without one; and
# MCClassS's conv_0_1 at 4096 points, the bucket site of tasks.modelnet.
SEG_B, SEG_N, SEG_CLASSES, SEG_RADII, SEG_NEIGHBOR_K = 8, 8192, 8, (0.05, 0.15, 0.4), 32
SEG_SITES = [("stem", 0, 0, 0.05, 1, 64), ("enc_0_1", 0, 1, 0.1, 64, None),
             ("dec_2_1", 2, 1, 0.3, 384, None), ("dec_1_0", 1, 0, 0.1, 256, None)]
MODELNET_SITE = ("MCClassS conv_0_1 at 4096", 0, 1, 0.2, 1, 128)
# Every dense conv site of the classification zoo at its published widths
# (mccnn_tpu/models/mcclass.py, mcclass_h.py), N = 1024: MCClass (grow 64) on
# the hierarchy 0.1 / 0.2 / 0.4, MCClassH (grow 128) on path A's 0.1 / 0.4 and
# path B's 0.1 / 0.2 / 0.4. (name, hierarchy radii, in level, out level,
# radius (None: the global radius), C, CO (None: depthwise)).
ZOO_SITES = [
    ("MCClass stem", RADII_3, 0, 0, 0.1, 1, 64),
    ("MCClass down_0_1", RADII_3, 0, 1, 0.2, 64, None),
    ("MCClass same_1", RADII_3, 1, 1, 0.2, 128, None),
    ("MCClass down_1_2", RADII_3, 1, 2, 0.4, 128, None),
    ("MCClass same_2", RADII_3, 2, 2, 0.4, 256, None),
    ("MCClass down_2_3", RADII_3, 2, 3, 0.8, 256, None),
    ("MCClass same_3", RADII_3, 3, 3, 0.8, 512, None),
    ("MCClass down_3_4", RADII_3, 3, 4, None, 512, None),
    ("MCClassH path_a conv_0_1", RADII_2, 0, 1, 0.2, 1, 128),
    ("MCClassH path_a conv_1_2", RADII_2, 1, 2, 0.8, 128, 256),
    ("MCClassH path_a conv_2_3", RADII_2, 2, 3, None, 256, 1024),
    ("MCClassH path_b conv_1_2", RADII_3, 1, 2, 0.4, 1, 128),
    ("MCClassH path_b conv_2_3", RADII_3, 2, 3, 0.8, 128, 256),
    ("MCClassH path_b conv_3_4", RADII_3, 3, 4, None, 256, 1024),
]


def _levels(points, mask, radii, global_level, dev):
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy

    hier = build_hierarchy(torch.from_numpy(points), torch.from_numpy(mask), radii,
                           global_level=global_level)
    return [(lv.points.to(dev), lv.mask.to(dev)) for lv in hier.levels]


def _clouds(seed: int, b: int) -> np.ndarray:
    """``b`` synthetic classification clouds of 1024 points, normalised."""
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.data.synthetic import classification_batch

    pts, _ = classification_batch(np.random.default_rng(seed), b, 1024)
    return np.stack([_normalize_np(p) for p in pts])


def mcclass_s_sites(b: int, dev) -> list:
    """MCClassS's three conv sites on a batch of ``b`` synthetic clouds:
    ``(name, sample level, source level, radius, C, CO)``, with the levels."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS

    lv = _levels(_clouds(SEED + b, b), np.ones((b, 1024), bool), RADII_2, True, dev)
    return [("MCClassS conv_0_1", lv[1], lv[0], 0.2, 1, 128),
            ("MCClassS conv_1_2", lv[2], lv[1], 0.8, 128, 256),
            ("MCClassS conv_2_g", lv[3], lv[2], GLOBAL_RADIUS, 256, 1024)]


def shapenet_sites(b: int, dev) -> list:
    """ShapeNet's MCSeg (grow 64, radii 0.025 / 0.1 / 0.4) at its three
    1024 -> 1024 sites: the stem (level 0 to 0, r 0.025, 1 + 16 category
    channels to 64), enc_0_1 (0 to 1, r 0.05, depthwise 64) and dec_1_0 (1 to
    0, r 0.05, depthwise 256), as ``mcclass_s_sites`` gives them."""
    from mccnn_tpu_torch.tasks.shapenet import SyntheticSegSource

    src = SyntheticSegSource(b, SHAPENET_PARTS, SHAPENET_CATS, SEED + 52)
    batch = next(src.batches(b, 1024, np.random.default_rng(SEED + 52)))
    lv = _levels(batch["points"], batch["mask"], SHAPENET_RADII, False, dev)
    r1 = 2 * SHAPENET_RADII[0]
    return [("ShapeNet stem", lv[0], lv[0], SHAPENET_RADII[0], 1 + SHAPENET_CATS, 64),
            ("ShapeNet enc_0_1", lv[1], lv[0], r1, 64, None),
            ("ShapeNet dec_1_0", lv[0], lv[1], r1, 256, None)]


def zoo_sites(b: int, dev) -> list:
    """The 14 sites of ``ZOO_SITES`` on a batch of ``b`` synthetic clouds (the
    clouds ``chip_smoke.py`` checks K1v1 / K2v1 on), as ``mcclass_s_sites``
    gives them."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS

    pts, mask = _clouds(SEED + 20 + b, b), np.ones((b, 1024), bool)
    lvs = {radii: _levels(pts, mask, radii, True, dev) for radii in (RADII_3, RADII_2)}
    return [(name, lvs[radii][o], lvs[radii][i], GLOBAL_RADIUS if r is None else r, c, co)
            for name, radii, i, o, r, c, co in ZOO_SITES]


def site_inputs(site, gen, dev):
    """Seeded parameters, weighted features and dout of one site."""
    from mccnn_tpu_torch.core.mcconv import init_mcconv_params
    from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel

    _, (smp, qmask), (src, smask), radius, c, co = site
    b, n = src.shape[:2]
    params = init_mcconv_params(gen, c, co, device=dev)
    params = params._replace(b1=0.1 * torch.randn(params.b1.shape, generator=gen).to(dev),
                             b2=0.1 * torch.randn(params.b2.shape, generator=gen).to(dev))
    feats = torch.randn((b, n, c), generator=gen).to(dev)
    pdf = density_kernel.kde_density_reference(src, smask, radius)
    wf = dense_conv._weighted_features(feats, pdf, smask)
    dout = torch.randn((b, smp.shape[1], c if co is None else co), generator=gen).to(dev)
    return params, smp, qmask, src, smask, wf, dout


def other_library_path(checkout: str) -> str:
    """Build the other checkout's kernel library there: its path."""
    code = "from mccnn_tpu_torch.ops.cuda import _build; print(_build.library().path)"
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def other_library(checkout: str, signatures: dict):
    """Build the other checkout's kernel library there and load it, with the
    argument types of ``signatures`` (name -> types)."""
    lib = ctypes.CDLL(other_library_path(checkout))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def other_k1v1(lib, params, smp, qmask, src, smask, wf, radius, co, mean=False):
    """The other checkout's K1v1, as its wrapper launched it: ``(out, cnt)``."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build

    ptr = _build.ptr
    b, m, _ = smp.shape
    n, c = src.shape[1], wf.shape[-1]
    out = torch.zeros((b, m, c if co is None else co), dtype=torch.float32, device=smp.device)
    cnt = torch.zeros((b, m), dtype=torch.float32, device=smp.device)
    _build.check(lib.mcconv_v1_fwd_launch(
        ptr(smp), ptr(qmask), ptr(src), ptr(smask), ptr(wf), ptr(params.w1), ptr(params.b1),
        ptr(params.w2), ptr(params.b2), b, m, n, c, co or 0, H, int(mean), radius_sq(radius),
        float(radius), ptr(out), ptr(cnt), _build.stream_of(smp)), "other K1v1")
    return out, cnt


def other_k2v1(lib, params, smp, qmask, src, smask, wf, radius, cnt, dout, co, mean=False):
    """The other checkout's K2v1, as its wrapper launched it (per-block
    [dW2; db2] partials), its partials summed by this checkout's reduction
    kernel: ``(d_wf, dw1, db1, dw2, db2)``."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build, dense_conv

    ptr, this = _build.ptr, _build.library()
    b, m, _ = smp.shape
    n, c = src.shape[1], wf.shape[-1]
    dev, stream = smp.device, _build.stream_of(smp)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    L = (H + 1) * c * (1 if co is None else co)
    d_wf, w1b1 = zeros(b, n, c), zeros(4, H)
    dwcat = zeros(H + 1, c) if co is None else zeros(L)
    tiles = lib.mcconv_v1_bwd_tiles(n, m, c, co or 0)
    blocks = max(1, min(b * tiles, OTHER_V1_BLOCKS, OTHER_V1_PARTIAL_FLOATS // L))
    part_w, part_p = zeros(blocks, L), zeros(blocks, 4 * H)
    _build.check(lib.mcconv_v1_bwd_launch(
        ptr(smp), ptr(qmask), ptr(src), ptr(smask), ptr(wf), ptr(params.w1), ptr(params.b1),
        ptr(params.w2), ptr(params.b2), ptr(cnt), ptr(dout), b, m, n, c, co or 0, H, int(mean),
        radius_sq(radius), float(radius), blocks, ptr(d_wf), ptr(part_w), ptr(part_p), stream),
        "other K2v1")
    for part, out in ((part_w, dwcat), (part_p, w1b1)):
        _build.check(this.mcconv_bwd_reduce_launch(ptr(part), blocks, part.shape[1], ptr(out),
                                                   stream), "reduce")
    return (d_wf, w1b1[:3], w1b1[3],
            *dense_conv._split_wcat(dwcat, H, c, co, params.w2, params.b2))


def k1(pair_lib, other, params, smp, qmask, src, smask, wf, radius, co, part=None,
       given=None):
    """K1 with ``pair_lib``'s pair kernel and projection (the other
    checkout's where ``other``): ``(out, cnt, G)``, as
    ``dense_conv._forward_cuda``; ``part="pair"`` runs
    the pair kernel alone, ``part="project"`` the projection alone (of the
    ``given`` (cnt, G))."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build, dense_conv

    lib, ptr = _build.library(), _build.ptr
    b, m, _ = smp.shape
    n, c = src.shape[1], wf.shape[-1]
    if part == "project":
        cnt, G = given
    else:
        G = torch.empty((b, m, H + 1, c), dtype=torch.float32, device=smp.device)
        cnt = torch.empty((b, m), dtype=torch.float32, device=smp.device)
    out = torch.empty((b, m, c if co is None else co), dtype=torch.float32, device=smp.device)
    stream = _build.stream_of(smp)
    if part != "project":
        _build.check(pair_lib.mcconv_pair_launch(
            ptr(smp), ptr(qmask), ptr(src), ptr(smask), ptr(wf), ptr(params.w1),
            ptr(params.b1), b, m, n, c, H, radius_sq(radius), float(radius), ptr(G), ptr(cnt),
            stream), "pair")
        if part == "pair":
            return out, cnt, G
    scale = dense_conv._scale(cnt, qmask, False).contiguous()
    if co is None:
        err = lib.mcconv_project_depthwise_launch(ptr(G), ptr(params.w2), ptr(params.b2),
                                                  ptr(scale), b * m, H, c, ptr(out), stream)
        _build.check(err, "projection")
    elif other:
        _build.check(pair_lib.mcconv_project_full_launch(
            ptr(G), ptr(params.w2), ptr(params.b2), ptr(scale), b * m, (H + 1) * c, H * c, co,
            ptr(out), stream), "projection")
    else:
        dense_conv.project_full(G, params.w2, params.b2, scale, b * m, (H + 1) * c, H * c, co,
                                out, "projection")
    return out, cnt, G


def k2(pair_lib, other, params, smp, qmask, src, smask, wf, radius, G, cnt, dout, co,
       part=None, given=None):
    """K2 with ``pair_lib``'s pair kernel and dG GEMM (the other
    checkout's where ``other``; this checkout's forms a depthwise dG inside
    its pair kernel) and this checkout's dW2 GEMM and reductions: ``(d_wf,
    dw1, db1, dw2, db2)``, as ``dense_conv.dense_mc_conv_backward_cuda``;
    ``part="gemm"`` runs the dG and dW2 GEMMs alone, ``part="pair"`` the pair
    kernel and its reduction alone (on the ``given`` dG, or t)."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build, dense_conv

    lib, ptr = _build.library(), _build.ptr
    b, m, _ = smp.shape
    n, c = src.shape[1], wf.shape[-1]
    R, H1 = b * m, H + 1
    dev = smp.device
    t = (dout * dense_conv._scale(cnt, qmask, False)[..., None]).contiguous()
    w2, b2 = params.w2, params.b2
    stream = _build.stream_of(smp)
    depthwise = co is None and not other  # this checkout's K2 reads t at depthwise sites
    if part == "pair":
        dG = t if depthwise else given
        dwcat = torch.zeros((H1, c) if co is None else (H1 * c * co,), device=dev)
    else:
        dG = t if depthwise else torch.empty((b, m, H1, c), dtype=torch.float32, device=dev)
        if co is None:
            if other:
                _build.check(pair_lib.mcconv_bwd_dg_depthwise_launch(
                    ptr(t), ptr(w2), ptr(b2), R, H, c, ptr(dG), stream), "dG")
            dwcat = dense_conv.wcat_grad(G, t, R, H1, c, depthwise=True)
        else:
            if other:
                _build.check(pair_lib.mcconv_bwd_dg_full_launch(
                    ptr(t), ptr(w2), ptr(b2), R, co, H * c, H1 * c, ptr(dG), stream), "dG")
            else:
                dense_conv.dg_full(t, w2, b2, R, co, H * c, H1 * c, dG, "dG")
            dwcat = dense_conv.wcat_grad(G, t, R, H1 * c, co)
    if part == "gemm":
        return dwcat
    blocks = (b * pair_lib.mcconv_bwd_pair_blocks(n, m, c) if other
              else pair_lib.mcconv_bwd_pair_blocks(b, n, m, c))
    part = torch.empty((blocks, 4, H), dtype=torch.float32, device=dev)
    d_wf = torch.zeros((b, n, c), dtype=torch.float32, device=dev)
    head = (ptr(smp), ptr(qmask), ptr(src), ptr(smask), ptr(wf), ptr(params.w1), ptr(params.b1))
    tail = (radius_sq(radius), float(radius), ptr(d_wf), ptr(part), stream)
    if other:
        err = pair_lib.mcconv_bwd_pair_launch(*head, ptr(dG), b, m, n, c, H, *tail)
    else:
        err = pair_lib.mcconv_bwd_pair_launch(*head, ptr(w2), ptr(b2), ptr(dG), b, m, n, c, H,
                                              int(depthwise), *tail)
    _build.check(err, "bwd pair")
    w1b1 = torch.empty((4, H), dtype=torch.float32, device=dev)
    _build.check(lib.mcconv_bwd_reduce_launch(ptr(part), blocks, 4 * H, ptr(w1b1), stream),
                 "reduce")
    return (d_wf, w1b1[:3], w1b1[3], *dense_conv._split_wcat(dwcat, H, c, co, w2, b2))


def other_k1p(lib, params, smp, qmask, src, smask, wf, radius, co):
    """The other checkout's K1p pair kernel, as its wrapper launched it, then
    this checkout's projection: ``(out, cnt, G)``."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build

    ptr = _build.ptr
    b, m, _ = smp.shape
    n, c = src.shape[1], wf.shape[-1]
    G = torch.empty((b, m, H + 1, c), dtype=torch.float32, device=smp.device)
    cnt = torch.empty((b, m), dtype=torch.float32, device=smp.device)
    _build.check(lib.mcconv_planes_pair_launch(
        ptr(smp), ptr(qmask), ptr(src), ptr(smask), ptr(wf), ptr(params.w1), ptr(params.b1),
        b, m, n, c, H, radius_sq(radius), float(radius), ptr(G), ptr(cnt), _build.stream_of(smp)),
        "other K1p")
    return k1(None, False, params, smp, qmask, src, smask, wf, radius, co, part="project",
              given=(cnt, G))


def rel_diff(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def main_v1(other, dev) -> int:
    """K1v1 / K2v1 of this checkout against ``other``'s at the zoo's 14 sites."""
    from mccnn_tpu_torch.ops.cuda import dense_conv

    from . import best_ms

    gen = torch.Generator().manual_seed(SEED + 20)
    total = np.zeros(4)  # K1v1 other, this; K2v1 other, this
    for site in zoo_sites(B, dev):
        name, _, _, radius, c, co = site
        params, smp, qmask, src, smask, wf, dout = site_inputs(site, gen, dev)
        fargs = (params, smp, qmask, src, smask, wf, radius, co)
        with torch.no_grad():
            o_out, o_cnt = other_k1v1(other, *fargs)
            n_out, n_cnt = dense_conv._forward_cuda_v1(*fargs, False)
            bargs = (params, smp, qmask, src, smask, wf, radius, n_cnt, dout)
            o_bwd = other_k2v1(other, *bargs, co)
            n_bwd = dense_conv.dense_mc_conv_v1_backward_cuda(*bargs, c_out=co)
            torch.cuda.synchronize()
            runs = {"K1v1": {"other": lambda: other_k1v1(other, *fargs),
                             "this": lambda: dense_conv._forward_cuda_v1(*fargs, False)},
                    "K2v1": {"other": lambda: other_k2v1(other, *bargs, co),
                             "this": lambda: dense_conv.dense_mc_conv_v1_backward_cuda(
                                 *bargs, c_out=co)}}
            times = {}
            for kid, fns in runs.items():
                for who in ("other", "this", "this", "other"):
                    # the best of 5 runs of 20 calls (host-bound calls are noisy),
                    # of 3 runs of 3 where one call takes over 5 ms (the other K2v1)
                    fast = best_ms(fns[who], iters=1, reps=1) < 5
                    ms = best_ms(fns[who], iters=20 if fast else 3, reps=5 if fast else 3)
                    times[kid, who] = min(times.get((kid, who), float("inf")), ms)
        total += [times["K1v1", "other"], times["K1v1", "this"], times["K2v1", "other"],
                  times["K2v1", "this"]]
        grads = ", ".join(f"{g} {rel_diff(a, r):.3e}" for g, a, r in
                          zip(("d_wf", "dw1", "db1", "dw2", "db2"), n_bwd, o_bwd))
        print(f"{name} B={smp.shape[0]} M={smp.shape[1]} N={src.shape[1]} C={c} CO={co}: "
              f"cnt_bit_equal={torch.equal(o_cnt, n_cnt)} out_bit_equal="
              f"{torch.equal(o_out, n_out)} out_rel_diff={rel_diff(n_out, o_out):.3e}; K2v1 "
              f"rel_diff {grads}; K1v1_ms other={times['K1v1', 'other']:.4f} "
              f"this={times['K1v1', 'this']:.4f} K2v1_ms other={times['K2v1', 'other']:.4f} "
              f"this={times['K2v1', 'this']:.4f}", flush=True)
    print(f"over the {len(ZOO_SITES)} sites: K1v1_ms other={total[0]:.4f} this={total[1]:.4f} "
          f"K2v1_ms other={total[2]:.4f} this={total[3]:.4f}", flush=True)
    return 0


def main_planes(other, dev) -> int:
    """K1p of this checkout against ``other``'s at the zoo's 14 sites and
    MCClassS's 3."""
    from mccnn_tpu_torch.ops.cuda import dense_conv

    from . import best_ms

    gen = torch.Generator().manual_seed(SEED + 30)
    total = np.zeros(3)  # K1p other, this; K1 this
    sites = zoo_sites(B, dev) + mcclass_s_sites(B, dev)
    for site in sites:
        name, _, _, radius, c, co = site
        params, smp, qmask, src, smask, wf, _ = site_inputs(site, gen, dev)
        fargs = (params, smp, qmask, src, smask, wf, radius, co)
        with torch.no_grad():
            o_out, o_cnt, o_G = other_k1p(other, *fargs)
            n_out, n_cnt, n_G = dense_conv.dense_mc_conv_planes_cuda(*fargs)
            torch.cuda.synchronize()
            fns = {"other": lambda: other_k1p(other, *fargs),
                   "this": lambda: dense_conv.dense_mc_conv_planes_cuda(*fargs)}
            times = {}
            for who in ("other", "this", "this", "other"):
                times[who] = min(times.get(who, float("inf")), best_ms(fns[who], iters=10))
            k1_ms = best_ms(lambda: dense_conv._forward_cuda(*fargs, False), iters=10)
        total += [times["other"], times["this"], k1_ms]
        same = torch.equal(o_G, n_G)
        print(f"{name} B={smp.shape[0]} M={smp.shape[1]} N={src.shape[1]} C={c} CO={co}: "
              f"cnt_bit_equal={torch.equal(o_cnt, n_cnt)} G_bit_equal={same}"
              + ("" if same else f" G_rel_diff={rel_diff(n_G, o_G):.3e}")
              + f" out_bit_equal={torch.equal(o_out, n_out)}; K1p_ms other={times['other']:.4f} "
              f"this={times['this']:.4f} K1_ms this={k1_ms:.4f}", flush=True)
    print(f"over the {len(sites)} sites: K1p_ms other={total[0]:.4f} this={total[1]:.4f} "
          f"K1_ms this={total[2]:.4f}", flush=True)
    return 0


def main_same(other_path: str, dev) -> int:
    """K1 / K2, K1v1 / K2v1 and K1p through this checkout's wrappers on this
    library and on ``other_path``'s, bit for bit, and each pair's device
    time summed over the sites on both libraries."""
    from mccnn_tpu_torch.ops.cuda import _build, dense_conv

    from . import device_ms

    libs = {"this": _build.library(), "other": _build.KernelLibrary(other_path, 0.0, "")}
    kinds = ("K1 + K2", "K1v1 + K2v1", "K1p")
    total = {(k, who): 0.0 for k in kinds for who in libs}
    gen = torch.Generator().manual_seed(SEED + 40)
    sites = zoo_sites(B, dev) + mcclass_s_sites(B, dev) + shapenet_sites(B, dev)
    names = ("K1 out", "cnt", "G", "d_wf", "dw1", "db1", "dw2", "db2", "K1v1 out", "K1v1 cnt",
             "v1 d_wf", "v1 dw1", "v1 db1", "v1 dw2", "v1 db2", "K1p out", "K1p cnt", "K1p G")
    every = True
    try:
        for site in sites:
            name, _, _, radius, c, co = site
            params, smp, qmask, src, smask, wf, dout = site_inputs(site, gen, dev)
            fargs = (params, smp, qmask, src, smask, wf, radius, co, False)
            res = {}
            with torch.no_grad():
                for who, lib in libs.items():
                    _build._LIBRARY = lib
                    out, cnt, G = dense_conv._forward_cuda(*fargs)
                    grads = dense_conv.dense_mc_conv_backward_cuda(
                        params, smp, qmask, src, smask, wf, radius, G, cnt, dout, c_out=co)
                    out1, cnt1 = dense_conv._forward_cuda_v1(*fargs)
                    grads1 = dense_conv.dense_mc_conv_v1_backward_cuda(
                        params, smp, qmask, src, smask, wf, radius, cnt1, dout, c_out=co)
                    planes = dense_conv.dense_mc_conv_planes_cuda(*fargs[:-1])
                    torch.cuda.synchronize()
                    res[who] = (out, cnt, G, *grads, out1, cnt1, *grads1, *planes)
                bargs = (params, smp, qmask, src, smask, wf, radius)

                def k1_k2():
                    _, cnt, G = dense_conv._forward_cuda(*fargs)
                    return dense_conv.dense_mc_conv_backward_cuda(*bargs, G, cnt, dout, c_out=co)

                def k1v1_k2v1():
                    _, cnt = dense_conv._forward_cuda_v1(*fargs)
                    return dense_conv.dense_mc_conv_v1_backward_cuda(*bargs, cnt, dout, c_out=co)

                runs = {"K1 + K2": k1_k2, "K1v1 + K2v1": k1v1_k2v1,
                        "K1p": lambda: dense_conv.dense_mc_conv_planes_cuda(*fargs[:-1])}
                times = {}
                for who in ("other", "this", "this", "other"):
                    _build._LIBRARY = libs[who]
                    for kind, fn in runs.items():
                        ms = device_ms(fn, iters=3)
                        times[kind, who] = min(times.get((kind, who), float("inf")), ms)
            for key, ms in times.items():
                total[key] += ms
            differ = [n for n, a, b in zip(names, res["this"], res["other"])
                      if not torch.equal(a, b)]
            every &= not differ
            print(f"{name} B={smp.shape[0]} M={smp.shape[1]} N={src.shape[1]} C={c} CO={co}: "
                  f"K1 / K2 / K1v1 / K2v1 / K1p outputs bit-equal: {not differ}"
                  + (f" (differ: {', '.join(differ)})" if differ else "") + "; device_ms "
                  + ", ".join(f"{k} other={times[k, 'other']:.4f} this={times[k, 'this']:.4f}"
                              for k in kinds), flush=True)
    finally:
        _build._LIBRARY = libs["this"]
    print(f"over the {len(sites)} sites: every output bit-equal: {every}; device_ms "
          + ", ".join(f"{k} other={total[k, 'other']:.4f} this={total[k, 'this']:.4f} "
                      f"(this / other {total[k, 'this'] / total[k, 'other']:.4f})"
                      for k in kinds), flush=True)
    return 0 if every else 1


def main_t1(other_path: str, dev) -> int:
    """T1 noop, mm_only and mm_big through this checkout's wrapper on this
    library and on ``other_path``'s: bit-equal or not, and both times."""
    from mccnn_tpu_torch.ops.cuda import _build, dense_probe

    from . import best_ms, device_ms
    from .dense_breakdown import RADIUS, inputs

    libs = {"this": _build.library(), "other": _build.KernelLibrary(other_path, 0.0, "")}
    pts, feats, w1, b1, w2, b2 = inputs(dev)
    args = (pts, feats.to(torch.bfloat16), w1, b1, w2, b2, RADIUS)
    every = True
    try:
        for v in ("noop", "mm_only", "mm_big"):
            fn = lambda v=v: dense_probe.dense_probe_cuda(v, *args)  # noqa: E731
            outs, call, dms = {}, {}, {}
            with torch.no_grad():
                for who in ("other", "this", "this", "other"):
                    _build._LIBRARY = libs[who]
                    outs[who] = fn()
                    torch.cuda.synchronize()
                    call[who] = min(call.get(who, float("inf")), best_ms(fn, iters=10))
                    dms[who] = min(dms.get(who, float("inf")), device_ms(fn, iters=10))
            same = torch.equal(outs["this"], outs["other"])
            every &= same
            print(f"T1 {v}: bit_equal={same}"
                  + ("" if same else f" rel_diff={rel_diff(outs['this'], outs['other']):.3e}")
                  + f"; call_ms other={call['other']:.4f} this={call['this']:.4f}; device_ms "
                  f"other={dms['other']:.4f} this={dms['this']:.4f} "
                  f"(this / other {dms['this'] / dms['other']:.3f})", flush=True)
    finally:
        _build._LIBRARY = libs["this"]
    print(f"T1 noop, mm_only, mm_big: every output bit-equal: {every}", flush=True)
    return 0 if every else 1


def _scene_batch(seed: int):
    from mccnn_tpu_torch.tasks.scannet import SyntheticSceneSource

    batch = next(SyntheticSceneSource(4, SEG_CLASSES, seed).batches(
        SEG_B, SEG_N, np.random.default_rng(seed)))
    return torch.from_numpy(batch["points"]), torch.from_numpy(batch["mask"])


def _seg_inputs(gen, src, smask, c, co, radius, dev):
    from mccnn_tpu_torch.ops.cuda import density_kernel

    params = init_params(gen, c, co, dev)
    b, n = src.shape[:2]
    feats = (torch.ones((b, n, 1)) if c == 1 else torch.randn((b, n, c), generator=gen)).to(dev)
    pdf = density_kernel.kde_density_reference(src, smask, radius)
    return params, feats, pdf


def init_params(gen, c, co, dev):
    from mccnn_tpu_torch.core.mcconv import init_mcconv_params

    params = init_mcconv_params(gen, c, co, device=dev)
    return params._replace(b1=0.1 * torch.randn(params.b1.shape, generator=gen).to(dev),
                           b2=0.1 * torch.randn(params.b2.shape, generator=gen).to(dev))


def tile_bwd_sites(dev) -> list:
    """``(name, run(lib), C, CO)`` at the four tile sites; ``run(None)`` is
    this checkout's K6, ``run(lib)`` the other library's."""
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.ops.cuda import tile_conv

    pts, mask = (x.to(dev) for x in _scene_batch(SEED + 5))
    tile_pairs = tile_conv.auto_tile_pairs(pts, mask, 2 * SEG_RADII[0])
    with torch.no_grad():
        hier = build_hierarchy(pts, mask, SEG_RADII, tile_pairs=tile_pairs)
    lv = [(h.points, h.mask) for h in hier.levels]
    gen = torch.Generator().manual_seed(SEED + 11)
    sites = []
    for name, i, o, radius, c, co in SEG_SITES:
        (src, smask), (smp, qmask) = lv[i], lv[o]
        params, feats, pdf = _seg_inputs(gen, src, smask, c, co, radius, dev)
        lay = tile_conv.conv_layout(smp, qmask, src, smask, radius, backward=True,
                                    max_pairs=tile_pairs if 0 in (i, o) else 1 << 30)
        wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
        with torch.no_grad():
            _, cnt = tile_conv.tile_conv_sorted_cuda(params, lay, wf, radius, c_out=co)
        dout = torch.randn((smp.shape[0], lay.smp.shape[1], co or c), generator=gen).to(dev)
        args = (params, lay, wf, radius, cnt, dout, co)
        sites.append((name, lambda lib, a=args: (other_k6(lib, *a) if lib is not None else
                                                 tile_conv._launch_k6(*a, False, False,
                                                                      parts=True)),
                      params, wf, c, co))
    return sites


def other_k6(lib, params, lay, wf, radius, cnt, dout, co):
    """The other checkout's K6 as its wrapper launched it: ``(out, w1part,
    w2part)``, its dG GEMM at the full site by this checkout's kernel."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build, dense_conv, tile_conv

    ptr = _build.ptr
    t = tile_conv._cotangent(lay, cnt, dout, False).contiguous()
    st = lay.steps_b
    B, NS, _ = lay.smp.shape
    NP, C = wf.shape[1:]
    CO = co or C
    H1 = H + 1
    ntp = NP // tile_conv.DEFAULT_TILE
    CB = min(max(C, CO), OTHER_CB)
    nb = -(-max(C, CO) // CB)
    dev = wf.device
    w1part = dense_conv.partials(B * ntp * nb, 4 * H, dev)
    if co is None:
        dG, out, w2part = t, torch.empty((B, NP, C), device=dev), dense_conv.partials(
            B * ntp, H1 * C, dev)
    else:
        dG, out, w2part = torch.empty((B, NS, H1, C), device=dev), torch.empty(
            (B, NP, H1, CO), device=dev), w1part
        dense_conv.dg_full(t, params.w2, params.b2, B * NS, CO, H * C, H1 * C, dG, "other dG")
    _build.check(lib.tile_conv_bwd_launch(
        ptr(lay.smp), ptr(lay.smp_valid), ptr(lay.src), ptr(lay.src_valid), ptr(wf), ptr(t),
        ptr(dG), ptr(st.j_ids), ptr(st.run), *(ptr(x) for x in params), B, NS, NP, C, CO, CB, H,
        st.j_ids.shape[2], st.j_ids.shape[1], ntp, st.n_minor, st.Tm, radius_sq(radius),
        float(radius), int(co is None), ptr(out), ptr(w1part), ptr(w2part),
        _build.stream_of(wf)), "other K6")
    return out, w1part, w2part


def bucket_bwd_sites(dev) -> list:
    """As ``tile_bwd_sites`` for K10: the four bucket sites and MCClassS's
    conv_0_1 at 4096 points."""
    from mccnn_tpu_torch.api.builder import SpatialCache
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.data.synthetic import classification_batch
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk

    pts, mask = (x.to(dev) for x in _scene_batch(SEED + 12))
    cloud, _ = classification_batch(np.random.default_rng(SEED + 17), B, 4096)
    cloud = torch.from_numpy(np.stack([_normalize_np(x) for x in cloud])).to(dev)
    with torch.inference_mode():
        seg = SpatialCache(build_hierarchy(pts, mask, SEG_RADII, neighbor_k=SEG_NEIGHBOR_K))
        cls = SpatialCache(build_hierarchy(cloud, torch.ones(cloud.shape[:2], dtype=torch.bool,
                                                             device=dev), RADII_2,
                                           global_level=True))
    gen = torch.Generator().manual_seed(SEED + 14)
    sites = []
    for cache, (name, i, o, radius, c, co) in [(seg, s) for s in SEG_SITES] + [(cls,
                                                                                MODELNET_SITE)]:
        hier = cache.hierarchy
        src, smask = hier.levels[i].points, hier.levels[i].mask
        gs, gp = cache.buckets(o, radius), cache.buckets(i, radius)
        params, feats, pdf = _seg_inputs(gen, src, smask, c, co, radius, dev)
        wf = torch.where(mk.kept_points(gp)[..., None], feats / pdf[..., None], 0.0)
        with torch.no_grad():
            _, cnt = mk.bucket_conv_cuda(params, gs, gp, wf, c_out=co)
        M = hier.levels[o].points.shape[1]
        dout = torch.randn((src.shape[0], M, co or c), generator=gen).to(dev)
        args = (params, gs, gp, wf, cnt, dout, co)
        sites.append((name, lambda lib, a=args: (
            other_k10(lib, *a) if lib is not None else
            mk._conv_backward_cuda("K10", *a, False, None, parts=True)), params, wf, c, co))
    return sites


def other_k10(lib, params, gs, gp, wf, cnt, dout, co):
    """The other checkout's K10 as its wrapper launched it: ``(out, w1part,
    w2part)``."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build, dense_conv
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk

    ptr = _build.ptr
    t = (dout * dense_conv._scale(cnt, mk.kept_points(gs), False)[..., None]).contiguous()
    (w1, b1, w2, b2), smp, src = mk._kernel_inputs("other K10", params, gs, gp, wf, t)
    B, M = gs.slot_of_point.shape
    N, C = wf.shape[1:]
    CO = co or C
    H1 = H + 1
    rows = min(gp.cap, OTHER_SLOTS)
    chunks = -(-gp.cap // rows)
    CB = min(max(C, CO), OTHER_CB)
    n_cb = -(-max(C, CO) // CB)
    blocks = B * gp.res**3 * chunks
    dev = wf.device
    w1part = dense_conv.partials(blocks * n_cb, 4 * H, dev)
    if co is None:
        dG, out, w2part = t, torch.zeros((B, N, C), device=dev), dense_conv.partials(
            blocks, H1 * C, dev)
    else:
        dG, out, w2part = torch.empty((B, M, H1, C), device=dev), torch.zeros(
            (B, N, H1, CO), device=dev), w1part
        dense_conv.dg_full(t, w2, b2, B * M, CO, H * C, H1 * C, dG, "other dG")
    _build.check(lib.bucket_conv_bwd_launch(
        *(ptr(x) for x in (*smp, *src, wf, t, dG, w1, b1, w2, b2)), B, M, N, C, CO, H, gp.res,
        gs.cap, gp.cap, rows, chunks, CB, radius_sq(gp.radius), float(gp.radius),
        int(co is None), ptr(out), ptr(w1part), ptr(w2part), _build.stream_of(wf)), "other K10")
    return out, w1part, w2part


def main_source_bwd(kid: str, other, sites) -> int:
    """K6 or K10 (``kid``) on this library and ``other`` at ``sites``."""
    from mccnn_tpu_torch.ops.cuda import tile_conv

    from . import device_ms

    every = True
    total = np.zeros(4)  # kernel other, this; whole backward other, this
    for name, run, params, wf, c, co in sites:
        libs = {"other": other, "this": None}
        grads = lambda parts: tile_conv.source_grads(params, wf, *parts, co, kid)  # noqa: E731
        with torch.no_grad():
            parts = {who: run(lib) for who, lib in libs.items()}
            res = {who: grads(p) for who, p in parts.items()}
            torch.cuda.synchronize()
            times = {}
            for who in ("other", "this", "this", "other"):
                fns = (lambda lib=libs[who]: run(lib),
                       lambda lib=libs[who]: grads(run(lib)))
                for k, fn in enumerate(fns):
                    ms = device_ms(fn, iters=3)
                    times[who, k] = min(times.get((who, k), float("inf")), ms)
        same = torch.equal(parts["this"][0], parts["other"][0])
        every &= same
        diffs = ", ".join(f"{g} {rel_diff(a, r):.3e}" for g, a, r in
                          zip(("dw1", "db1", "dw2", "db2"), res["this"][1:], res["other"][1:]))
        total += [times["other", 0], times["this", 0], times["other", 1], times["this", 1]]
        print(f"{kid} {name} C={c} CO={co}: {'X' if co else 'd_f~'}_bit_equal={same}"
              + ("" if same else
                 f" rel_diff={rel_diff(parts['this'][0], parts['other'][0]):.3e}")
              + f"; rel_diff {diffs}; kernel device_ms other={times['other', 0]:.4f} "
              f"this={times['this', 0]:.4f}; backward device_ms other={times['other', 1]:.4f} "
              f"this={times['this', 1]:.4f}", flush=True)
    print(f"{kid} over the {len(sites)} sites: kernel device_ms other={total[0]:.4f} "
          f"this={total[1]:.4f}; backward device_ms other={total[2]:.4f} this={total[3]:.4f}; "
          f"every kernel output bit-equal: {every}", flush=True)
    return 0 if every else 1


def main(argv=None) -> int:
    from mccnn_tpu_torch.ops.cuda import _build

    from . import best_ms, card_line, require_card

    argv = sys.argv[1:] if argv is None else argv
    modes = ("--v1", "--planes", "--same", "--t1", "--tile-bwd", "--bucket-bwd")
    mode = argv[0] if argv[:1] and argv[0] in modes else None
    argv = argv[1:] if mode else argv
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        raise SystemExit("usage: python -m mccnn_tpu_torch.tools.dense_ab "
                         f"[{' | '.join(modes)}] OTHER_CHECKOUT")
    dev = require_card("dense_ab")
    print("card:", card_line(), flush=True)
    if mode == "--v1":
        return main_v1(other_library(argv[0], OTHER_V1_SIGNATURES), dev)
    if mode == "--planes":
        return main_planes(other_library(argv[0], OTHER_PLANES_SIGNATURES), dev)
    if mode == "--same":
        return main_same(other_library_path(argv[0]), dev)
    if mode == "--t1":
        return main_t1(other_library_path(argv[0]), dev)
    if mode == "--tile-bwd":
        return main_source_bwd("K6", other_library(argv[0], OTHER_TILE_SIGNATURES),
                               tile_bwd_sites(dev))
    if mode == "--bucket-bwd":
        return main_source_bwd("K10", other_library(argv[0], OTHER_BUCKET_SIGNATURES),
                               bucket_bwd_sites(dev))
    this = _build.library()
    other = other_library(argv[0], {**OTHER_SIGNATURES, "mcconv_bwd_pair_blocks": OTHER_BLOCKS})
    gen = torch.Generator().manual_seed(SEED)
    sites = mcclass_s_sites(B, dev) + shapenet_sites(B, dev)
    for site in sites:
        name, _, _, radius, c, co = site
        params, smp, qmask, src, smask, wf, dout = site_inputs(site, gen, dev)
        fargs = (params, smp, qmask, src, smask, wf, radius, co)
        with torch.no_grad():
            o_out, o_cnt, o_G = k1(other, True, *fargs)
            n_out, n_cnt, n_G = k1(this, False, *fargs)
            bargs = (params, smp, qmask, src, smask, wf, radius, n_G, n_cnt, dout, co)
            o_bwd = k2(other, True, *bargs)
            n_bwd = k2(this, False, *bargs)
            torch.cuda.synchronize()
            dG0 = torch.zeros_like(n_G)
            times = {}
            for who, lib, is_other in (("other", other, True), ("this", this, False),
                                       ("this", this, False), ("other", other, True)):
                ms1 = best_ms(lambda: k1(lib, is_other, *fargs), iters=10)
                ms2 = best_ms(lambda: k2(lib, is_other, *bargs), iters=10)
                ms3 = best_ms(lambda: k1(lib, is_other, *fargs, part="pair"), iters=10)
                ms4 = best_ms(lambda: k2(lib, is_other, *bargs, part="pair", given=dG0),
                              iters=10)
                prev = times.get(who, (float("inf"),) * 4)
                times[who] = tuple(min(a, x) for a, x in zip(prev, (ms1, ms2, ms3, ms4)))
            proj = [best_ms(lambda: k1(lib, is_other, *fargs, part="project", given=(n_cnt, n_G)),
                            iters=10) for lib, is_other in ((other, True), (this, False))]
            gemm = [best_ms(lambda: k2(lib, is_other, *bargs, part="gemm"), iters=10)
                    for lib, is_other in ((other, True), (this, False))]
        same = {"G": torch.equal(o_G, n_G), "cnt": torch.equal(o_cnt, n_cnt),
                "out": torch.equal(o_out, n_out), "d_wf": torch.equal(o_bwd[0], n_bwd[0]),
                "dw2": torch.equal(o_bwd[3], n_bwd[3]), "db2": torch.equal(o_bwd[4], n_bwd[4])}
        out_rel = float((o_out - n_out).abs().max()) / max(float(o_out.abs().max()), 1e-30)
        dw1 = float((o_bwd[1] - n_bwd[1]).abs().max()) / max(float(o_bwd[1].abs().max()), 1e-30)
        db1 = float((o_bwd[2] - n_bwd[2]).abs().max()) / max(float(o_bwd[2].abs().max()), 1e-30)
        print(f"{name} B={smp.shape[0]} M={smp.shape[1]} N={src.shape[1]} C={c} CO={co}: "
              f"bit_equal {same} out_rel_diff={out_rel:.3e} dw1_rel_diff={dw1:.3e} "
              f"db1_rel_diff={db1:.3e} "
              f"K1_ms other={times['other'][0]:.4f} this={times['this'][0]:.4f} "
              f"K2_ms other={times['other'][1]:.4f} this={times['this'][1]:.4f}; "
              f"pair kernels alone: K1 other={times['other'][2]:.4f} this={times['this'][2]:.4f} "
              f"K2 (+ its reduction) other={times['other'][3]:.4f} "
              f"this={times['this'][3]:.4f}; GEMM parts: K1 projection other={proj[0]:.4f} "
              f"this={proj[1]:.4f} K2 dG + dW2 other={gemm[0]:.4f} this={gemm[1]:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
