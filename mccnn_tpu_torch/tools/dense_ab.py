"""K1 and K2 with this checkout's pair kernels against another checkout's, on
the same inputs in one process on the card.

    python -m mccnn_tpu_torch.tools.dense_ab OTHER_CHECKOUT

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


def _levels(points, mask, radii, global_level, dev):
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy

    hier = build_hierarchy(torch.from_numpy(points), torch.from_numpy(mask), radii,
                           global_level=global_level)
    return [(lv.points.to(dev), lv.mask.to(dev)) for lv in hier.levels]


def mcclass_s_sites(b: int, dev) -> list:
    """MCClassS's three conv sites on a batch of ``b`` synthetic clouds:
    ``(name, sample level, source level, radius, C, CO)``, with the levels."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.data.synthetic import classification_batch

    pts, _ = classification_batch(np.random.default_rng(SEED + b), b, 1024)
    pts = np.stack([_normalize_np(p) for p in pts])
    lv = _levels(pts, np.ones((b, 1024), bool), (0.1, 0.4), True, dev)
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


def other_library(checkout: str):
    """Build the other checkout's kernel library there and load it."""
    code = "from mccnn_tpu_torch.ops.cuda import _build; print(_build.library().path)"
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True,
                         text=True, check=True)
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    for name, argtypes in OTHER_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.mcconv_bwd_pair_blocks.argtypes = OTHER_BLOCKS
    lib.mcconv_bwd_pair_blocks.restype = ctypes.c_int
    return lib


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


def main(argv=None) -> int:
    from mccnn_tpu_torch.ops.cuda import _build

    from . import best_ms, card_line, require_card

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        raise SystemExit("usage: python -m mccnn_tpu_torch.tools.dense_ab OTHER_CHECKOUT")
    dev = require_card("dense_ab")
    print("card:", card_line(), flush=True)
    this, other = _build.library(), other_library(argv[0])
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
