"""Kernels of this checkout against another checkout's, on the same inputs
in one process on the card.

    python -m mccnn_tpu_torch.tools.dense_ab --tile-fwd OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --bucket-fwd OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --same OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --t1 OTHER_CHECKOUT
    python -m mccnn_tpu_torch.tools.dense_ab --sweeps OTHER_CHECKOUT

The other checkout's kernel library is built there (its own
``ops/cuda/_build.py``, in a child process) and loaded beside this one's,
with this checkout's argument types (``_build.SIGNATURES``). A mode runs only
the entry points whose arguments it names: ``--tile-fwd`` and
``--bucket-fwd`` declare the ABI of K5 / K5p and K9 / K9a (``FWD_ABI``, the
arguments since their ports) and refuse to run where this checkout's
``_build.SIGNATURES`` differ from it; ``--sweeps`` declares those of K4's
all-pairs body, K8, K7 and K3 (``SWEEP_ABI``) and also refuses another
checkout whose ``_build.SIGNATURES`` differ from it; ``--same`` and ``--t1`` are for a
checkout whose library has this checkout's entry points and arguments.

With ``--tile-fwd`` it runs K5 and K5p (``tile_conv_launch`` /
``tile_conv_packed_launch``, the kernels alone on preallocated outputs,
K5p on records packed beforehand) on both libraries at ``chip_smoke.py``'s
tile sites: ScanNet's MCSeg on a block batch of 8 x 8192 points at its four
big conv sites (stem, enc_0_1, dec_2_1, dec_1_0: ``SEG_SITES``) with a tile
capacity. Per site it prints whether ``out`` (depthwise) or G (the full
stem) and the counts are bit-equal between the libraries, whether K5p equals
K5 on each, both libraries' device times (``device_ms``, order other, this,
this, other) and the sum over the sites. With ``--bucket-fwd`` it runs K9
(``bucket_conv_launch``) and K9a (``bucket_conv_active_launch`` at NBA =
the occupied bricks, lossless) the same way at the four sites without a
tile capacity, MCClassS's conv_0_1 at B = 32 x 4096 (``MODELNET_SITE``) and
``tools.bucket_32k``'s 32k scene (cap 64, NBA 784): per site whether ``out``
/ G and the counts are bit-equal, whether K9a equals K9, and both times.

With ``--same`` it runs this checkout's wrappers of K1 / K2, K1v1 / K2v1 and
K1p at the zoo's 14 dense sites, MCClassS's 3 and ShapeNet's 3 (B = 32), of
K5, K5p and K6 at the four tile sites and of K9, K10 and K9a / K10a (at a
lossless NBA) at the five bucket sites on each library, and prints per site
whether every output is bit-equal, with each kind's device time summed over
its sites on both libraries. With ``--t1`` it runs T1 noop, mm_only and
mm_big through this checkout's wrapper on each library at
``tools.dense_breakdown``'s inputs, the features given in bf16 (the kernels
alone), and prints for each whether the outputs are bit-equal and both
libraries' call and device times (``best_ms``, ``device_ms``; order other,
this, this, other).

With ``--sweeps`` it runs K8 (``tile_cover_launch``, through this
checkout's wrapper) on both libraries at the 27 colours of the tile
sampler's level-0 sweep, on ``chip_smoke.py``'s block batch (8 x 8192) and
its 40960-point scene, the colours' flags those of the sampler's own replay,
and prints whether every count is bit-equal and both libraries' device times
of a whole sweep (27 launches). Then K4 at ScanNet MCSeg's seven KDE sites
of that block batch (level 0 at r = 0.05 and 0.1, level 1 at 0.1 and 0.3,
level 2 at 0.3 and 0.8, level 3 at 0.8) and at MCClassS's three (B = 8 and
32): the other library's ``kde_density_launch`` alone against this
checkout's ``kde_density_cuda`` (the body ``pick_body`` takes, its sort
included), with both of this checkout's bodies beside them; per site the
largest relative difference from the other's output, whether this all-pairs
body is bit-equal to it, and the device times (order other, this, this,
other). Then K7 (``tile_kde_launch``, through this checkout's wrapper) at
the 40960 scene's two level-0 radii on ``chip_smoke.py``'s layouts: its
real and inert steps, whether the sums are bit-equal (else the largest
relative difference, held to TILE_RTOL), whether this one is bitwise on
repeat, and both device times, each radius and summed; and K3
(``poisson_sweep_launch``) at ``poisson_sites``, every dense sweep of a
default path: whether the selection is bit-equal and both device times,
each site and summed over each path's sites.

It refuses to run without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
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
# The arguments of the tile and bucket forwards' entry points, unchanged since
# each was first built: a checkout with these takes `--tile-fwd` / `--bucket-fwd`.
FWD_ABI = {
    "tile_conv_launch": [P] * 11 + [I] * 10 + [F, F, I, I] + [P] * 3,
    "tile_conv_packed_launch": [P] * 9 + [I] * 9 + [F, F, I, I] + [P] * 3,
    "bucket_conv_launch": [P] * 11 + [I] * 8 + [F, F, I, I] + [P] * 3,
    "bucket_conv_active_launch": [P] * 12 + [I] * 10 + [F, F, I, I] + [P] * 3,
}
# The arguments of K4's all-pairs body, K8, K7 and K3, unchanged since their
# ports: a checkout with these takes `--sweeps`.
SWEEP_ABI = {
    "kde_density_launch": [P, P, I, I, F, F, F, P, P],
    "tile_cover_launch": [P, P, P, P, P, I, I, I, I, I, I, F, P, P],
    "tile_kde_launch": [P, P, P, P, I, I, I, I, I, I, F, F, P, P],
    "poisson_sweep_launch": [P, P, P, P, I, I, F, P, P],
}
TILE_RTOL = 1e-4  # K7 against another body of the same sums (chip_smoke.py's tolerance)
ACTIVE_CAP, ACTIVE_NBA = 64, 784  # tools.bucket_32k's scene: every occupied brick

RADII_3, RADII_2 = (0.1, 0.2, 0.4), (0.1, 0.4)
# ScanNet's MCSeg at the CLI's defaults on a block batch (as chip_smoke.py):
# its four big conv sites (name, in level, out level, radius, C, CO), each
# the tile conv's with a tile capacity and the bucket conv's without one; and
# MCClassS's conv_0_1 at 4096 points, the bucket site of tasks.modelnet.
SEG_B, SEG_N, SEG_CLASSES, SEG_RADII, SEG_NEIGHBOR_K = 8, 8192, 8, (0.05, 0.15, 0.4), 32
SEG_CAP = 40960  # the whole scene's padded size (chip_smoke.py)
# MCSeg's KDE sites at those defaults (level, radius): each conv's source
# level at its radius. The block batch's levels hold 8192, 1944, 224 and 40
# points, all within the dense KDE's bound: K4 at every one.
SEG_KDE_SITES = [(0, 0.05), (0, 0.1), (1, 0.1), (1, 0.3), (2, 0.3), (2, 0.8), (3, 0.8)]
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


def rel_diff(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def main_same(other_path: str, dev) -> int:
    """K1 / K2, K1v1 / K2v1 and K1p at the dense sites, K5, K5p and K6 at the
    tile sites and K9, K10 and K9a / K10a at the bucket sites, through this
    checkout's wrappers on this library and on ``other_path``'s: bit for bit,
    and each kind's device time summed over its sites on both libraries."""
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
        for name, runs in same_conv_runs(dev):
            res, times = {}, {}
            with torch.no_grad():
                for who, lib in libs.items():
                    _build._LIBRARY = lib
                    res[who] = {k: fn() for k, fn in runs.items()}
                    torch.cuda.synchronize()
                for who in ("other", "this", "this", "other"):
                    _build._LIBRARY = libs[who]
                    for kind, fn in runs.items():
                        ms = device_ms(fn, iters=3)
                        times[kind, who] = min(times.get((kind, who), float("inf")), ms)
            for key, ms in times.items():
                total[key] = total.get(key, 0.0) + ms
            differ = [k for k in runs if not all(
                torch.equal(a, b) for a, b in zip(res["this"][k], res["other"][k]))]
            every &= not differ
            print(f"{name}: {' / '.join(runs)} outputs bit-equal: {not differ}"
                  + (f" (differ: {', '.join(differ)})" if differ else "") + "; device_ms "
                  + ", ".join(f"{k} other={times[k, 'other']:.4f} this={times[k, 'this']:.4f}"
                              for k in runs), flush=True)
    finally:
        _build._LIBRARY = libs["this"]
    kinds = list(dict.fromkeys(k for k, _ in total))
    print(f"over every site: every output bit-equal: {every}; device_ms "
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


def whole_scene(seed: int):
    """One synthetic scene normalised and padded to SEG_CAP points, B = 1
    (numpy points and mask)."""
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.tasks.scannet import SyntheticSceneSource

    scene = SyntheticSceneSource(1, SEG_CLASSES, seed)._src.scenes[0]
    pts = np.zeros((1, SEG_CAP, 3), np.float32)
    pts[0, : len(scene)] = _normalize_np(scene)
    return pts, (np.arange(SEG_CAP) < len(scene))[None]


def cover_colours(pts, mask, radius, tile_pairs, counts) -> tuple:
    """The tile sampler's level-0 sweep replayed colour by colour, as
    ``core/sampling.py::_poisson_tiles`` runs it: ``(sweep, flags, selected)``,
    the 27 colours' candidate flags over sorted rows and the selection in the
    original order. ``counts(layout, flags)`` gives a colour's cover counts."""
    from mccnn_tpu_torch.core import sampling
    from mccnn_tpu_torch.core.grid import cell_color27, linear_cell_ids
    from mccnn_tpu_torch.ops.cuda import tile_conv

    B, N, _ = pts.shape
    coords, res = sampling._sampler_grid(pts, radius)
    cids, colors = linear_cell_ids(coords, res), cell_color27(coords)
    order = sampling._cell_hilbert_order(coords, mask, res)
    sweep = tile_conv.make_cover_sweep(pts, mask, radius, max_pairs=tile_pairs, order=order)
    rows = sweep.valid.shape[1]

    def sort1(x):
        s = torch.gather(x, 1, order)
        return torch.cat([s, s.new_full((B, rows - N), -1)], dim=1)

    s_cids, s_colors = sort1(cids), sort1(colors)
    seg_start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=pts.device),
                           s_cids[:, 1:] != s_cids[:, :-1]], dim=1)
    selected = torch.zeros((B, rows), dtype=torch.bool, device=pts.device)
    covered = torch.zeros_like(selected)
    flags = []
    for c in range(27):
        uncovered = sweep.valid & ~covered
        u = uncovered.to(torch.int32)
        excl = torch.cumsum(u, dim=1, dtype=torch.int32) - u
        base = torch.cummax(torch.where(seg_start, excl, -1), dim=1).values
        cand = uncovered & (excl == base) & (s_colors == c)
        flags.append(cand)
        selected |= cand
        covered |= counts(sweep.layout, cand) > 0
    sel = torch.empty((B, N), dtype=torch.bool, device=pts.device)
    sel.scatter_(1, order, selected[:, :N])
    return sweep, flags, sel


def tile_sites(dev) -> list:
    """``(name, params, lay, wf, radius, c, co, cnt, dout)`` at the four tile
    sites, with both step lists, the plain count and a seeded dout."""
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
            _, cnt = tile_conv.tile_conv_sorted_reference(params, lay, wf, radius, c_out=co)
        dout = torch.randn((smp.shape[0], lay.smp.shape[1], co or c), generator=gen).to(dev)
        sites.append((name, params, lay, wf, radius, c, co, cnt, dout))
    return sites


def bucket_sites(dev, with_32k: bool = False) -> list:
    """``(name, params, gs, gp, wf, c, co, cnt, dout, active)`` at the four
    bucket sites and MCClassS's conv_0_1 at 4096 points (and, with
    ``with_32k``, ``tools.bucket_32k``'s scene): ``active`` holds the bricks
    of a lossless NBA, every occupied one."""
    from mccnn_tpu_torch.api.builder import SpatialCache
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.data.synthetic import classification_batch
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk

    from . import bucket_32k

    pts, mask = (x.to(dev) for x in _scene_batch(SEED + 12))
    cloud, _ = classification_batch(np.random.default_rng(SEED + 17), B, 4096)
    cloud = torch.from_numpy(np.stack([_normalize_np(x) for x in cloud])).to(dev)
    with torch.inference_mode():
        seg = SpatialCache(build_hierarchy(pts, mask, SEG_RADII, neighbor_k=SEG_NEIGHBOR_K))
        cls = SpatialCache(build_hierarchy(cloud, torch.ones(cloud.shape[:2], dtype=torch.bool,
                                                             device=dev), RADII_2,
                                           global_level=True))
    gen = torch.Generator().manual_seed(SEED + 14)
    cases = []
    for cache, (name, i, o, radius, c, co) in [(seg, s) for s in SEG_SITES] + [(cls,
                                                                                MODELNET_SITE)]:
        hier = cache.hierarchy
        src, smask = hier.levels[i].points, hier.levels[i].mask
        params, feats, pdf = _seg_inputs(gen, src, smask, c, co, radius, dev)
        cases.append((name, params, cache.buckets(o, radius), cache.buckets(i, radius), feats,
                      pdf, c, co))
    if with_32k:
        s = bucket_32k.scene(dev, ACTIVE_CAP)
        cases.append(("bucket_32k scene", s["params"], s["grid"], s["grid"], s["feats"],
                      s["pdf"], s["feats"].shape[-1], None))
    sites = []
    for name, params, gs, gp, feats, pdf, c, co in cases:
        wf = torch.where(mk.kept_points(gp)[..., None], feats / pdf[..., None], 0.0)
        with torch.no_grad():
            _, cnt = mk.bucket_conv_reference(params, gs, gp, wf, c_out=co)
        dout = torch.randn((wf.shape[0], cnt.shape[1], co or c), generator=gen).to(dev)
        bz = mk.pick_bz(gp.res, min(gs.cap, gp.cap))
        nba = max(int(mk.brick_occupancy(g, bz).sum(dim=-1).max()) for g in (gs, gp))
        active = mk.ActiveBricks(mk._brick_activity(gs, bz, nba), mk._brick_activity(gp, bz, nba),
                                 bz)
        sites.append((name, params, gs, gp, wf, c, co, cnt, dout, active))
    return sites


def check_abi(abi: dict, other: str | None = None) -> None:
    """Refuse to run where this checkout's entry points of ``abi`` (or, given
    ``other``, that checkout's) take other arguments than it declares: the
    other library is called with this checkout's argument types."""
    from mccnn_tpu_torch.ops.cuda import _build

    names = {n: [t.__name__ for t in ts] for n, ts in abi.items()}
    sigs = [{n: [t.__name__ for t in _build.SIGNATURES[n]] for n in abi}]
    if other is not None:
        code = ("import json; from mccnn_tpu_torch.ops.cuda import _build; print(json.dumps("
                f"{{n: [t.__name__ for t in _build.SIGNATURES.get(n, [])] for n in {sorted(abi)!r}}}))")
        out = subprocess.run([sys.executable, "-c", code], cwd=other, capture_output=True,
                             text=True, check=True)
        sigs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    moved = sorted({n for s in sigs for n in abi if s[n] != names[n]})
    if moved:
        raise SystemExit(f"dense_ab: {', '.join(moved)} take other arguments than the mode "
                         "declares; declare the other checkout's")


def k5_alone(lib, packed: bool, params, lay, wf, radius, co, rec):
    """K5 (or, with ``packed``, K5p on the records ``rec``) of library
    ``lib`` alone: a function that launches it and returns ``(out or G,
    cnt)``, its outputs allocated once."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build, tile_conv

    ptr = _build.ptr
    st = lay.steps
    b, ns, _ = lay.smp.shape
    c = wf.shape[-1]
    dst = torch.empty((b, ns, c) if co is None else (b, ns, H + 1, c), device=wf.device)
    cnt = torch.empty((b, ns), device=wf.device)
    weights = [ptr(x) for x in (st.j_ids, st.run, *params)]
    tail = (b, ns, c, H, st.j_ids.shape[2], st.j_ids.shape[1], ns // tile_conv.DEFAULT_TILE,
            st.n_minor, st.Tm, radius_sq(radius), float(radius), 0, int(co is None), ptr(dst),
            ptr(cnt))

    def run():
        stream = _build.stream_of(wf)
        if packed:
            err = lib.tile_conv_packed_launch(ptr(lay.smp), ptr(lay.smp_valid), ptr(rec), *weights,
                                              *tail, stream)
        else:
            err = lib.tile_conv_launch(ptr(lay.smp), ptr(lay.smp_valid), ptr(lay.src),
                                       ptr(lay.src_valid), ptr(wf), *weights, lay.src.shape[1],
                                       *tail, stream)
        _build.check(err, "K5p" if packed else "K5")
        return dst, cnt
    return run


def k9_alone(lib, active, params, gs, gp, wf, co):
    """K9 (or, with ``active``, K9a over its sample bricks) of library
    ``lib`` alone, as ``k5_alone``; its outputs zeroed once (rows of samples
    the layout does not keep are not written)."""
    from mccnn_tpu_torch.core.grid import radius_sq
    from mccnn_tpu_torch.ops.cuda import _build
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk

    ptr = _build.ptr
    b, m = gs.slot_of_point.shape
    n, c = wf.shape[1:]
    dst = torch.zeros((b, m, c) if co is None else (b, m, H + 1, c), device=wf.device)
    cnt = torch.zeros((b, m), device=wf.device)
    keep = (*mk._layout_tensors(gs), *mk._layout_tensors(gp), wf, *params)  # alive while run
    head = [ptr(x) for x in keep]
    tail = (radius_sq(gp.radius), float(gp.radius), 0, int(co is None), ptr(dst), ptr(cnt))
    dims = (b, m, n, c, H, gs.res, gs.cap, gp.cap)

    def run():
        stream = _build.stream_of(wf)
        if active is None:
            err = lib.bucket_conv_launch(*head, *dims, *tail, stream)
        else:
            err = lib.bucket_conv_active_launch(*head, ptr(active.smp.ids), *dims,
                                                active.smp.nba, active.bz, *tail, stream)
        _build.check(err, "K9" if active is None else "K9a")
        return dst, cnt
    run.inputs = keep
    return run


def main_fwd(kind: str, other_path: str, dev) -> int:
    """K5 / K5p (``kind`` "tile") or K9 / K9a ("bucket") of this library and
    ``other_path``'s at their sites: outputs bit-equal or not, and both
    libraries' device times of each kernel alone."""
    from mccnn_tpu_torch.ops.cuda import _build, tile_conv

    from . import device_ms

    names = (("tile_conv_launch", "tile_conv_packed_launch") if kind == "tile" else
             ("bucket_conv_launch", "bucket_conv_active_launch"))
    check_abi({n: FWD_ABI[n] for n in names})
    kids = ("K5", "K5p") if kind == "tile" else ("K9", "K9a")
    libs = {"this": _build.library(), "other": _build.KernelLibrary(other_path, 0.0, "")}
    every = True
    total = {(k, who): 0.0 for k in kids for who in libs}
    if kind == "tile":
        sites = []
        for name, params, lay, wf, radius, c, co, *_ in tile_sites(dev):
            params = tuple(x.contiguous() for x in params)
            rec = tile_conv.pack_minor_records(lay.src, lay.src_valid, wf, lay.steps.Tm,
                                               lay.steps.n_minor)
            sites.append((name, c, co, {
                (kid, who): k5_alone(lib, kid == "K5p", params, lay, wf, radius, co, rec)
                for kid in kids for who, lib in libs.items()}))
    else:
        sites = []
        for name, params, gs, gp, wf, c, co, _, _, active in bucket_sites(dev, with_32k=True):
            params = tuple(x.contiguous() for x in params)
            sites.append((name, c, co, {
                (kid, who): k9_alone(lib, active if kid == "K9a" else None, params, gs, gp, wf, co)
                for kid in kids for who, lib in libs.items()}))
    for name, c, co, runs in sites:
        with torch.no_grad():
            outs = {key: tuple(x.clone() for x in fn()) for key, fn in runs.items()}
            torch.cuda.synchronize()
            times = {}
            for who in ("other", "this", "this", "other"):
                for kid in kids:
                    ms = device_ms(runs[kid, who], iters=3)
                    times[kid, who] = min(times.get((kid, who), float("inf")), ms)
        parts = []
        for kid in kids:
            same = all(torch.equal(a, b) for a, b in zip(outs[kid, "this"], outs[kid, "other"]))
            every &= same
            parts.append(f"{kid} {'out' if co is None else 'G'} and cnt bit_equal={same}"
                         + ("" if same else
                            f" rel_diff={rel_diff(outs[kid, 'this'][0], outs[kid, 'other'][0]):.3e}"))
        for who in libs:
            same = all(torch.equal(a, b) for a, b in zip(outs[kids[1], who], outs[kids[0], who]))
            every &= same
            parts.append(f"{kids[1]} == {kids[0]} on {who}: {same}")
        for key, ms in times.items():
            total[key] += ms
        print(f"{name} C={c} CO={co}: {'; '.join(parts)}; kernel device_ms "
              + ", ".join(f"{k} other={times[k, 'other']:.4f} this={times[k, 'this']:.4f}"
                          for k in kids), flush=True)
    print(f"over the {len(sites)} sites: every output bit-equal: {every}; kernel device_ms "
          + ", ".join(f"{k} other={total[k, 'other']:.4f} this={total[k, 'this']:.4f} "
                      f"(this / other {total[k, 'this'] / total[k, 'other']:.4f})"
                      for k in kids), flush=True)
    return 0 if every else 1


def same_conv_runs(dev) -> list:
    """``(name, runs)`` at the tile and bucket sites for ``main_same``: runs
    maps a kind to a function of no arguments returning that kind's outputs
    through this checkout's wrappers."""
    from mccnn_tpu_torch.ops.cuda import mcconv_kernel as mk
    from mccnn_tpu_torch.ops.cuda import tile_conv

    sites = []
    for name, params, lay, wf, radius, c, co, cnt, dout in tile_sites(dev):
        kw = dict(c_out=co)
        bargs = (params, lay, wf, radius, cnt, dout)
        sites.append((f"tile {name} C={c} CO={co}", {
            "K5": lambda p=params, l=lay, w=wf, r=radius, kw=kw: tile_conv.tile_conv_sorted_cuda(
                p, l, w, r, **kw),
            "K5p": lambda p=params, l=lay, w=wf, r=radius, kw=kw:
                tile_conv.tile_conv_sorted_packed_cuda(p, l, w, r, **kw),
            "K6": lambda a=bargs, kw=kw: tile_conv.tile_conv_backward_sorted_cuda(*a, **kw)}))
    for name, params, gs, gp, wf, c, co, cnt, dout, active in bucket_sites(dev):
        kw = dict(c_out=co)
        fargs, bargs = (params, gs, gp, wf), (params, gs, gp, wf, cnt, dout)
        sites.append((f"bucket {name} C={c} CO={co}", {
            "K9": lambda a=fargs, kw=kw: mk.bucket_conv_cuda(*a, **kw),
            "K10": lambda a=bargs, kw=kw: mk.bucket_conv_backward_cuda(*a, **kw),
            "K9a + K10a": lambda a=fargs, b=bargs, x=active, kw=kw: (
                *mk.bucket_conv_active_cuda(*a, x, **kw),
                *mk.bucket_conv_backward_active_cuda(*b, x, **kw))}))
    return sites


def kde_sites(dev) -> list:
    """``(name, points, mask, radius)`` of K4 at MCSeg's seven KDE sites of
    the block batch and at MCClassS's three (B = 8 and 32)."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS, build_hierarchy
    from mccnn_tpu_torch.ops.cuda import tile_conv

    pts, mask = (x.to(dev) for x in _scene_batch(SEED + 5))
    tile_pairs = tile_conv.auto_tile_pairs(pts, mask, 2 * SEG_RADII[0])
    with torch.no_grad():
        hier = build_hierarchy(pts, mask, SEG_RADII, tile_pairs=tile_pairs)
    sites = [(f"ScanNet level {lv} r={r}", hier.levels[lv].points, hier.levels[lv].mask, r)
             for lv, r in SEG_KDE_SITES]
    for b in (8, B):
        lv = _levels(_clouds(SEED + b, b), np.ones((b, 1024), bool), RADII_2, True, dev)
        sites += [(f"MCClassS B={b} level {i} r={r:.4f}", *lv[i], r)
                  for i, r in ((0, 0.2), (1, 0.8), (2, GLOBAL_RADIUS))]
    return sites


def poisson_sites(dev) -> list:
    """``(path, name, points, mask, radius)`` of K3 at every dense sweep of
    a default path, ``path`` naming the forward the site belongs to:
    MCClassS's level 0 (N = 1024, r = 0.1) and level 1 (496, 0.4) at B = 8
    and 32; ScanNet MCSeg's level 1 (1944, 0.15) and level 2 (224, 0.4) of
    the block batch (B = 8) and of the 40960 scene (B = 1); ShapeNet MCSeg's
    levels 0 (1024, 0.025), 1 (1024, 0.1) and 2 (496, 0.4) at B = 32; and
    MCClassS's levels 0 (4096, 0.1) and 1 (496, 0.4) at ``tasks.modelnet
    --points 4096``, B = 32."""
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.data.synthetic import classification_batch
    from mccnn_tpu_torch.ops.cuda import tile_conv
    from mccnn_tpu_torch.tasks.shapenet import SyntheticSegSource

    def levels(path, lv, radii, which=None):
        return [(path, f"{path} level {i}", *lv[i], radii[i])
                for i in (range(len(radii)) if which is None else which)]

    sites = []
    for b in (8, B):
        lv = _levels(_clouds(SEED + b, b), np.ones((b, 1024), bool), RADII_2, True, dev)
        sites += levels(f"MCClassS B={b}", lv, RADII_2)
    block = [x.to(dev) for x in _scene_batch(SEED + 5)]
    scene = [torch.from_numpy(x).to(dev) for x in whole_scene(SEED + 6)]
    for path, (pts, mask) in (("ScanNet block batch", block), ("ScanNet scene", scene)):
        tile_pairs = tile_conv.auto_tile_pairs(pts, mask, 2 * SEG_RADII[0])
        with torch.no_grad():
            hier = build_hierarchy(pts, mask, SEG_RADII, tile_pairs=tile_pairs)
        lv = [(h.points, h.mask) for h in hier.levels]
        sites += levels(path, lv, SEG_RADII, which=(1, 2))  # level 0 is the tile sampler's
    batch = next(SyntheticSegSource(B, SHAPENET_PARTS, SHAPENET_CATS, SEED + 52).batches(
        B, 1024, np.random.default_rng(SEED + 52)))
    sites += levels("ShapeNet", _levels(batch["points"], batch["mask"], SHAPENET_RADII, False,
                                        dev), SHAPENET_RADII)
    pts, _ = classification_batch(np.random.default_rng(SEED + 4096), B, 4096)
    pts = torch.from_numpy(np.stack([_normalize_np(p) for p in pts])).to(dev)
    with torch.no_grad():  # on the device: the plain sweep at 32 x 4096 is slow on the host
        hier = build_hierarchy(pts, torch.ones((B, 4096), dtype=torch.bool, device=dev), RADII_2)
    sites += levels("--points 4096", [(h.points, h.mask) for h in hier.levels], RADII_2)
    return [(path, name, p.contiguous(), m.contiguous(), r) for path, name, p, m, r in sites]


def main_sweeps(other_path: str, dev) -> int:
    """K8 at the 27 colours of the block batch's and the scene's level-0
    sweeps, and K4 at the ScanNet and MCClassS KDE sites, on this library and
    ``other_path``'s: K8 bit for bit, K4's largest relative difference, and
    both device times."""
    from mccnn_tpu_torch.ops.cuda import _build, density_kernel, tile_conv

    from . import device_ms

    libs = {"this": _build.library(), "other": _build.KernelLibrary(other_path, 0.0, "")}
    every = True
    try:
        block = [x.to(dev) for x in _scene_batch(SEED + 5)]
        scene = [torch.from_numpy(x).to(dev) for x in whole_scene(SEED + 6)]
        for name, (pts, mask) in (("block batch 8 x 8192", block), ("scene 40960", scene)):
            tile_pairs = tile_conv.auto_tile_pairs(pts, mask, 2 * SEG_RADII[0])
            with torch.no_grad():
                sweep, flags, _ = cover_colours(pts, mask, SEG_RADII[0], tile_pairs,
                                                lambda lay, f: tile_conv.cover_counts_cuda(
                                                    lay, f, SEG_RADII[0]))

                def run(lay=sweep.layout, flags=flags):
                    return [tile_conv.cover_counts_cuda(lay, f, SEG_RADII[0]) for f in flags]

                outs, dms = {}, {}
                for who in ("other", "this", "this", "other"):
                    _build._LIBRARY = libs[who]
                    outs.setdefault(who, run())
                    torch.cuda.synchronize()
                    dms[who] = min(dms.get(who, float("inf")), device_ms(run, iters=3))
            same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))
            every &= same
            print(f"K8 {name} Tm={sweep.layout.steps.Tm} (27 colours, "
                  f"{sum(int(f.sum()) for f in flags)} flags): every count bit-equal: {same}; "
                  f"device_ms a sweep other={dms['other']:.4f} this={dms['this']:.4f} "
                  f"(this / other {dms['this'] / dms['other']:.4f})", flush=True)
        _build._LIBRARY = libs["this"]

        def other_k4(pts, mask, radius):
            r2, neg, norm = density_kernel._constants(radius, 0.25)
            out = torch.empty(mask.shape, dtype=torch.float32, device=dev)
            b, n = mask.shape
            _build.check(libs["other"].kde_density_launch(
                _build.ptr(pts), _build.ptr(mask), b, n, r2, neg, norm, _build.ptr(out),
                _build.stream_of(pts)), "the other K4")
            return out

        total = {}
        for name, pts, mask, radius in kde_sites(dev):
            pts, mask = pts.contiguous(), mask.contiguous()
            runs = {"other": lambda p=pts, m=mask, r=radius: other_k4(p, m, r),
                    "this": lambda p=pts, m=mask, r=radius: density_kernel.kde_density_cuda(
                        p, m, r)}
            for body in ("culled", "all_pairs"):
                runs[body] = lambda p=pts, m=mask, r=radius, bd=body: \
                    density_kernel.kde_density_cuda(p, m, r, body=bd)
            with torch.no_grad():
                outs = {k: fn() for k, fn in runs.items()}
                torch.cuda.synchronize()
                dms = {}
                for who in ("other", "this", "culled", "all_pairs", "all_pairs", "culled",
                            "this", "other"):
                    dms[who] = min(dms.get(who, float("inf")), device_ms(runs[who], iters=5))
            rel = {k: float(((outs[k] - outs["other"]).abs() / outs["other"].abs()).max())
                   for k in ("this", "culled")}
            plain_bits = torch.equal(outs["all_pairs"], outs["other"])
            every &= plain_bits and rel["this"] <= 1e-4 and rel["culled"] <= 1e-4
            for k, ms in dms.items():
                total[k] = total.get(k, 0.0) + ms
            print(f"K4 {name} B={mask.shape[0]} N={mask.shape[1]}: body "
                  f"{density_kernel.pick_body(mask.shape[1])}; largest relative difference "
                  f"from the other this={rel['this']:.3e} culled={rel['culled']:.3e}; "
                  f"all_pairs bit-equal to the other: {plain_bits}; device_ms "
                  f"other={dms['other']:.4f} this={dms['this']:.4f} "
                  f"(this / other {dms['this'] / dms['other']:.4f}) "
                  f"culled={dms['culled']:.4f} all_pairs={dms['all_pairs']:.4f}", flush=True)
        print(f"K4 over the sites: device_ms other={total['other']:.4f} "
              f"this={total['this']:.4f} culled={total['culled']:.4f} "
              f"all_pairs={total['all_pairs']:.4f}", flush=True)
        every &= sweeps_k7_k3(libs, scene, dev)
    finally:
        _build._LIBRARY = libs["this"]
    print(f"K8, K4, K7 and K3 against the other: every check held: {every}", flush=True)
    return 0 if every else 1


def _ab(libs, run, iters: int) -> tuple[dict, dict]:
    """``run`` on both libraries: its first outputs and the best device
    times, in the order other, this, this, other."""
    from mccnn_tpu_torch.ops.cuda import _build

    from . import device_ms

    outs, dms = {}, {}
    for who in ("other", "this", "this", "other"):
        _build._LIBRARY = libs[who]
        outs.setdefault(who, run())
        torch.cuda.synchronize()
        dms[who] = min(dms.get(who, float("inf")), device_ms(run, iters=iters))
    _build._LIBRARY = libs["this"]
    return outs, dms


def sweeps_k7_k3(libs, scene, dev) -> bool:
    """K7 at the 40960 scene's two level-0 radii (``chip_smoke.py``'s
    layouts) and K3 at ``poisson_sites``, on both libraries: K7 bit-equal
    or within TILE_RTOL, K3 bit for bit; both device times."""
    from mccnn_tpu_torch.core.sampling import sweep_cells
    from mccnn_tpu_torch.ops.cuda import poisson_kernel, tile_conv

    every = True
    pts, mask = scene
    tile_pairs = tile_conv.auto_tile_pairs(pts, mask, 2 * SEG_RADII[0])
    total = {"this": 0.0, "other": 0.0}
    for radius in (SEG_RADII[0], 2 * SEG_RADII[0]):
        with torch.no_grad():
            lay = tile_conv.self_layout(pts, mask, radius, max_pairs=tile_pairs)
            outs, dms = _ab(libs, lambda lay=lay, r=radius: tile_conv.tile_kde_sums_cuda(lay, r),
                            iters=5)
            repeat = bool(torch.equal(tile_conv.tile_kde_sums_cuda(lay, radius), outs["this"]))
        same = bool(torch.equal(outs["this"], outs["other"]))
        diff = (outs["this"] - outs["other"]).abs() / outs["other"].abs().clamp_min(1e-30)
        rel = float(diff[lay.valid].max())
        every &= repeat and (same or rel <= TILE_RTOL)
        real, inert = tile_conv.real_steps(lay.steps)
        for k in total:
            total[k] += dms[k]
        print(f"K7 scene 40960 r={radius} Tm={lay.steps.Tm} S={lay.S} (real steps "
              f"{int(real.sum())}, inert {int(inert.sum())}): bit-equal to the other: {same}; "
              f"largest relative difference {rel:.3e}; bitwise on repeat: {repeat}; device_ms "
              f"other={dms['other']:.4f} this={dms['this']:.4f} (this / other "
              f"{dms['this'] / dms['other']:.4f})",
              flush=True)
    print(f"K7 over the scene's two radii: device_ms other={total['other']:.4f} "
          f"this={total['this']:.4f} (this / other {total['this'] / total['other']:.4f})",
          flush=True)
    total = {}
    for path, name, pts, mask, radius in poisson_sites(dev):
        cids, colors = sweep_cells(pts, radius)
        args = (pts, mask, cids, colors, radius)
        with torch.no_grad():
            outs, dms = _ab(libs, lambda a=args: poisson_kernel.poisson_sweep_cuda(*a), iters=10)
        same = bool(torch.equal(outs["this"], outs["other"]))
        every &= same
        for k in dms:
            total.setdefault(path, {}).setdefault(k, 0.0)
            total[path][k] += dms[k]
        print(f"K3 {name} B={mask.shape[0]} N={mask.shape[1]} r={radius}: selected "
              f"{int(outs['this'].sum())}, bit-equal to the other: {same}; device_ms "
              f"other={dms['other']:.4f} this={dms['this']:.4f} (this / other "
              f"{dms['this'] / dms['other']:.4f})", flush=True)
    for path, dms in total.items():
        print(f"K3 {path}, its sites summed: device_ms other={dms['other']:.4f} "
              f"this={dms['this']:.4f} (this / other {dms['this'] / dms['other']:.4f})",
              flush=True)
    return every


def main(argv=None) -> int:
    from . import card_line, require_card

    argv = sys.argv[1:] if argv is None else argv
    modes = ("--tile-fwd", "--bucket-fwd", "--same", "--t1", "--sweeps")
    if len(argv) != 2 or argv[0] not in modes or not os.path.isdir(argv[1]):
        raise SystemExit("usage: python -m mccnn_tpu_torch.tools.dense_ab "
                         f"{{{' | '.join(modes)}}} OTHER_CHECKOUT")
    mode, other = argv
    dev = require_card("dense_ab")
    print("card:", card_line(), flush=True)
    if mode == "--sweeps":
        check_abi(SWEEP_ABI, other)
    path = other_library_path(other)
    if mode == "--sweeps":
        return main_sweeps(path, dev)
    if mode == "--same":
        return main_same(path, dev)
    if mode == "--t1":
        return main_t1(path, dev)
    return main_fwd("tile" if mode == "--tile-fwd" else "bucket", path, dev)


if __name__ == "__main__":
    sys.exit(main())
