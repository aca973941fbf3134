"""The tile kernels' roofline on the card: the port's twin of
``tools/exp_tile_roofline.py``.

    python -m mccnn_tpu_torch.tools.tile_roofline [n_points]     (default 32768)

On one synthetic scene (the reference tool's ``surface_scene``, seed 1:
``bench.py``'s scene) of ``n_points`` points, the depthwise tile conv at r =
0.05, C = 128, H = 8 over the step list the scene needs (``count_tile_steps``),
it prints the counted work (steps, slots, candidate pairs of the step list
against the scene's in-radius pairs) and times, with CUDA events (warm, best
of several calls), K5 and K6 and their probes (``MCCNN_TILE_PROBE``'s values,
``tile_conv.tile_conv_probe_sorted_cuda`` and
``tile_conv_backward_noop_sorted_cuda``):

- ``noop``: the loads, d2 and the count;
- ``planes``: + the H pre-activation planes, no contraction;
- ``mm``: + the contraction with d2 for every plane, no plane arithmetic;
- ``bwd_noop``: K6's staging and its d2 sweep into in-radius lists, which
  only count.

The kernels run on a layout built once (the TPU tool's chain-difference
timing answered the TPU's dispatch overhead; the card's events time the
launches alone). It then prints the reference tool's derived lines (fwd and
bwd, the noop share, the plane and contraction parts) and the H100's floors:
the fp32 operations over the card's 67 TFLOP/s and the bytes over its 3.35
TB/s (NVIDIA H100 SXM data sheet), counted over the candidate pairs the
kernels walk and over the in-radius pairs the function needs. It refuses to
run without a CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import PEAK_BYTES_PER_S, PEAK_FP32_FLOP_PER_S, best_ms, require_card

NB = 32768
RB, CB, H = 0.05, 128, 8
T, G = 128, 8


def surface_scene(rng, n):
    face = rng.integers(0, 5, size=n)
    u, v = rng.uniform(0, 1, (2, n))
    p = np.zeros((n, 3), np.float32)
    for f_, arr in [(0, np.stack([u, v, np.zeros_like(u)], -1)),
                    (1, np.stack([np.zeros_like(u), u, v], -1)),
                    (2, np.stack([np.ones_like(u), u, v], -1)),
                    (3, np.stack([u, np.zeros_like(u), v], -1)),
                    (4, np.stack([u, np.ones_like(u), v], -1))]:
        p[face == f_] = arr[face == f_]
    p += rng.normal(0, 0.01, size=p.shape)
    return np.clip(p, 0.0, 0.999).astype(np.float32)


def true_pairs(p, r):
    """Exact in-radius pair count (numpy, chunked)."""
    n = len(p)
    total = 0
    for i in range(0, n, 2048):
        d2 = ((p[i : i + 2048, None, :] - p[None, :, :]) ** 2).sum(-1)
        total += int((d2 <= r * r).sum())
    return total


def fwd_ops(pairs: int) -> int:
    """K5's fp32 operations over ``pairs`` (sample, source) pairs at C = CB,
    depthwise: d2, the offsets, H pre-activations and ReLUs, then (H+1) FMAs
    a channel."""
    return pairs * (8 + 6 + 6 * H + 2 * (H + 1) * CB)


def bwd_ops(pairs: int) -> int:
    """K6's: the same plane, X's (H+1) FMAs a channel, dpre's H dot products
    over the channels and its dW1 / db1 terms."""
    return pairs * (8 + 6 + 6 * H + 2 * (H + 1) * CB + 2 * H * CB + 8 * H)


def run(n_points: int = NB, iters: int = 5, reps: int = 3) -> dict:
    """Measure and print; returns the timings (ms), the counts and the
    timed calls' inputs (``case``: params, layout, wf, radius, K5's count,
    dout), on which a caller can check the kernels' outputs."""
    dev = require_card("tile_roofline")
    from ..core.mcconv import init_mcconv_params
    from ..ops.cuda import tile_conv

    rng = np.random.default_rng(1)  # bench.py's scene
    p_np = surface_scene(rng, n_points)
    pts = torch.from_numpy(p_np)[None].to(dev)
    mask = torch.ones((1, n_points), dtype=torch.bool, device=dev)
    feats = torch.from_numpy(rng.normal(size=(1, n_points, CB)).astype(np.float32)).to(dev)
    pdf = torch.ones((1, n_points), device=dev)
    params = init_mcconv_params(torch.Generator().manual_seed(0), CB, None, device=dev)

    Tm = tile_conv.tile_minor(T)
    Gm = G * (T // Tm)
    steps = int(tile_conv.count_tile_steps(pts, mask, pts, mask, RB).max())
    pairs = int(tile_conv._count_adjacency(pts, mask, pts, mask, RB, T, Tm).sum())
    slots = steps * Gm
    cand_pairs = slots * Tm * T
    tp = true_pairs(p_np, RB)
    print(f"N={n_points} r={RB} T={T} Tm={Tm} G={Gm}: steps={steps} tile_pairs={pairs} "
          f"slots={slots} cand_pairs={cand_pairs / 1e6:.0f}M true_pairs={tp / 1e6:.2f}M "
          f"overcompute={cand_pairs / tp:.1f}x", flush=True)

    lay = tile_conv.conv_layout(pts, mask, pts, mask, RB, max_pairs=1 << 30, max_steps=steps,
                                backward=True)
    wf = tile_conv._sorted_weighted_features(lay, feats, pdf)
    _, cnt = tile_conv.tile_conv_sorted_cuda(params, lay, wf, RB)
    dout = torch.randn((1, lay.smp.shape[1], CB), generator=torch.Generator().manual_seed(2))
    dout = dout.to(dev)
    bargs = (params, lay, wf, RB, cnt, dout)

    def fwd(probe=""):
        if probe:
            return lambda: tile_conv.tile_conv_probe_sorted_cuda(probe, params, lay, wf, RB)
        return lambda: tile_conv.tile_conv_sorted_cuda(params, lay, wf, RB)

    def fwd_bwd(backward):
        return lambda: (tile_conv.tile_conv_sorted_cuda(params, lay, wf, RB), backward(*bargs))

    rows = [("fwd noop (loads+d2)", fwd("noop")),
            ("fwd planes (no contraction)", fwd("planes")),
            ("fwd mm (no plane arithmetic)", fwd("mm")),
            ("fwd full", fwd()),
            ("fwd+bwd, bwd noop", fwd_bwd(tile_conv.tile_conv_backward_noop_sorted_cuda)),
            ("fwd+bwd full", fwd_bwd(tile_conv.tile_conv_backward_sorted_cuda))]
    d = {}
    for label, fn in rows:
        d[label] = best_ms(fn, iters, reps)
        print(f"  {label:30s} {d[label]:9.3f} ms", flush=True)

    f, fb = d["fwd full"], d["fwd+bwd full"]
    noop = d["fwd noop (loads+d2)"]
    planes, mm = d["fwd planes (no contraction)"], d["fwd mm (no plane arithmetic)"]
    bwd_noop = d["fwd+bwd, bwd noop"] - f
    print("\n--- derived ---")
    print(f"fwd {f:.3f} ms  bwd {fb - f:.3f} ms  total {fb:.3f} ms = "
          f"{n_points / fb / 1e3:.2f} Mpts/s")
    print(f"per-step {fb / steps * 1e3:.2f} us, per-slot {fb / slots * 1e3:.3f} us")
    print(f"fwd loads+d2: {noop:.3f} ms ({noop / f:.0%} of fwd)")
    print(f"fwd plane arithmetic: {planes - noop:.3f} ms; fwd contraction: {mm - noop:.3f} ms; "
          f"sum+noop vs full: {planes + mm - noop:.3f} vs {f:.3f} ms")
    print(f"bwd loads+d2: {bwd_noop:.3f} ms ({bwd_noop / (fb - f):.0%} of bwd)")
    nbytes_f = 4 * (2 * n_points * 3 + n_points * CB + 4 * H + 2 * H * CB + 2 * n_points * CB)
    nbytes_b = 4 * (2 * n_points * 3 + 3 * n_points * CB + 8 * H + 4 * H * CB) + 2 * n_points
    floors = {}
    for what, n in (("candidate", cand_pairs), ("in-radius", tp)):
        ff = max(fwd_ops(n) / PEAK_FP32_FLOP_PER_S, nbytes_f / PEAK_BYTES_PER_S) * 1e3
        bf = max(bwd_ops(n) / PEAK_FP32_FLOP_PER_S, nbytes_b / PEAK_BYTES_PER_S) * 1e3
        floors[what] = (ff, bf)
        print(f"H100 floor over the {what} pairs (fp32 67 TFLOP/s, 3.35 TB/s): fwd {ff:.3f} ms, "
              f"bwd {bf:.3f} ms -> measured fwd+bwd = {fb / (ff + bf):.1f}x the floor")
    return dict(times=d, steps=steps, slots=slots, cand_pairs=cand_pairs, true_pairs=tp,
                floors=floors, case=dict(params=params, lay=lay, wf=wf, radius=RB, cnt=cnt,
                                         dout=dout))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else NB)
    return 0


if __name__ == "__main__":
    sys.exit(main())
