"""Where the dense conv's time goes on the card: the port's twin of
``tools/exp_dense_breakdown.py``.

    python -m mccnn_tpu_torch.tools.dense_breakdown [variant ...]     (default: all)

At the reference tool's shapes (B = 8 clouds, N = M = 1024 points that are
both samples and sources, C = 128, H = 8, r = 0.2; uniform points, normal
features, seed 0) it times, with CUDA events (warm, best of several calls):

- ``fwd`` / ``layer``: the dense conv's forward (K1 and its projection,
  through ``dense_mc_conv``) and forward + backward (K1, K2), depthwise;
- ``fwd_planes``: the same forward with K1p (``MCCNN_DENSE_PLANES=mxu``);
- T1's variants (``ops/cuda/dense_probe.py``): ``replica``, ``mm_only``,
  ``vpu_only``, ``h1``, ``noop``, ``mm_big``, ``fwd_bf16``;
- ``xla_equiv``: mm_only's products as plain ``torch.matmul`` calls.

then the split of the forward it reads from them (loads = noop, planes =
vpu_only - noop - one contraction's share, contraction = mm_only - noop) and
two floors per variant on the H100, each the larger of its fp32 operations
over 67 TFLOP/s and its bytes over 3.35 TB/s (NVIDIA H100 SXM data sheet;
mm_big's walked work, which runs on the tensor cores, over their 989 TFLOP/s
bf16 peak):
the *function's* floor (``t1_ops``: d2 over every pair, planes and
contractions over the in-radius pairs this run's points hold, one
contraction where the planes are one plane; ``t1_bytes``: the inputs the
variant reads and its output) and the *walked-work* floor (the same work
over every pair, as the kernels walk them). It refuses to run without a
CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import (PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S, PEAK_FP32_FLOP_PER_S, best_ms,
               require_card)

B, N, M, C, H = 8, 1024, 1024, 128, 8
RADIUS = 0.2
ORDER = ("fwd", "layer", "fwd_planes", "replica", "mm_only", "vpu_only", "h1", "noop",
         "mm_big", "xla_equiv", "fwd_bf16")


def t1_ops(variant: str, pairs: int, inr: int, walked: bool = False) -> int:
    """fp32 operations of T1 ``variant``'s function over ``pairs`` (sample,
    source) pairs of which ``inr`` lie within the radius: d2 (8) over every
    pair; per in-radius pair and plane a subtract, an add and a ReLU (and
    vpu_only's running sum), and 2 C per contraction; the fold of the (H+1)
    products into the output. mm_only's and mm_big's plane is bf16(x_j),
    one plane for every sample and h: one product a cloud, then its fold.
    noop writes one value: no operations. With ``walked``, the work the
    kernels walk instead: planes and contractions over every pair, (H+1)
    contractions for mm_only / mm_big."""
    out = B * M * C
    if variant == "noop":
        return 0
    if variant in ("mm_only", "mm_big"):
        return pairs * 2 * (H + 1) * C if walked else 2 * B * N * C + 2 * (H + 1) * B * C
    per_pair = {"vpu_only": 4 * H + 2 * C, "h1": 3 + 2 * C,
                "replica": 3 * H + 2 * (H + 1) * C, "fwd_bf16": 3 * H + 2 * (H + 1) * C}[variant]
    fold = {"vpu_only": 0, "h1": out, "replica": 2 * (H + 1) * out,
            "fwd_bf16": 2 * (H + 1) * out}[variant]
    return 8 * pairs + (pairs if walked else inr) * per_pair + fold


def t1_bytes(variant: str) -> int:
    """Bytes T1 ``variant``'s function must move: the inputs it reads (fp32,
    as the wrapper takes them), each once, and its fp32 output written once.
    noop reads w2[0, 0] alone; mm_only / mm_big the x of the positions, the
    features and w2."""
    out = 4 * B * M * C
    if variant == "noop":
        return out + 4
    feats = 4 * B * N * C
    if variant in ("mm_only", "mm_big"):
        return 4 * B * N + feats + 4 * H * C + out
    params = {"vpu_only": 8 * H + H, "h1": 8 * H + H + C,
              "replica": 8 * H + H + H * C + C, "fwd_bf16": 8 * H + H + H * C + C}[variant]
    return 4 * B * N * 3 + feats + 4 * params + out


def t1_floor(variant: str, pairs: int, inr: int, walked: bool = False) -> float:
    """The H100 floor (ms) of ``t1_ops`` and ``t1_bytes``: fp32 operations,
    but mm_big's walked contractions at the bf16 tensor-core peak."""
    rate = PEAK_BF16_FLOP_PER_S if walked and variant == "mm_big" else PEAK_FP32_FLOP_PER_S
    return max(t1_ops(variant, pairs, inr, walked) / rate,
               t1_bytes(variant) / PEAK_BYTES_PER_S) * 1e3


def in_radius_pairs(pts) -> int:
    """(sample, source) pairs of ``pts`` within ``RADIUS``, as the kernels'
    fp32 d2 decides them (every sample is a source: M = N)."""
    from ..core.grid import pair_d2, radius_sq

    return int((pair_d2(pts, pts) <= radius_sq(RADIUS)).sum())


def inputs(dev):
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(0, 1, size=(B, N, 3)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    w1 = torch.from_numpy(rng.normal(size=(8, H)).astype(np.float32)).to(dev)
    b1 = torch.from_numpy(rng.normal(size=H).astype(np.float32)).to(dev)
    w2 = torch.from_numpy(rng.normal(size=(H, C)).astype(np.float32)).to(dev)
    b2 = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(dev)
    return pts, feats, w1, b1, w2, b2


def run(names=ORDER, iters: int = 5, reps: int = 3) -> dict:
    """Time and print ``names``; returns {name: ms}."""
    dev = require_card("dense_breakdown")
    from ..core.mcconv import init_mcconv_params
    from ..ops.cuda import dense_conv, dense_probe

    pts, feats, w1, b1, w2, b2 = inputs(dev)
    mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    pdf = torch.ones((B, N), device=dev)
    params = init_mcconv_params(torch.Generator().manual_seed(0), C, None, device=dev)
    wf = dense_conv._weighted_features(feats, pdf, mask)
    conv = (params, pts, mask, pts, mask, wf, RADIUS, None, False)

    def layer():
        f = feats.detach().requires_grad_()
        out = dense_conv.dense_mc_conv(params, pts, mask, pts, mask, f, pdf, RADIUS)
        out.square().sum().backward()

    fns = {"fwd": lambda: dense_conv._forward_cuda(*conv),
           "layer": layer,
           "fwd_planes": lambda: dense_conv.dense_mc_conv_planes_cuda(*conv),
           "xla_equiv": lambda: dense_probe.xla_equiv(pts, feats, w2)}
    for v in dense_probe.VARIANTS:
        fns[v] = (lambda v=v: dense_probe.dense_probe_cuda(v, pts, feats, w1, b1, w2, b2,
                                                           RADIUS))
    pairs, inr = B * M * N, in_radius_pairs(pts)
    print(f"B={B} N=M={N} C={C} H={H} r={RADIUS}: {pairs} pairs, {inr} in radius "
          f"({inr / pairs:.1%})", flush=True)
    times = {}
    for name in names:
        times[name] = best_ms(fns[name], iters, reps)
        line = f"{name:10s} {times[name]:8.3f} ms"
        if name in dense_probe.VARIANTS:
            floor, walked = t1_floor(name, pairs, inr), t1_floor(name, pairs, inr, walked=True)
            line += (f"   floor {floor:.4f} ms ({times[name] / floor:.0f}x)   walked-work floor "
                     f"{walked:.4f} ms ({times[name] / walked:.1f}x)")
        print(line, flush=True)
    if {"noop", "mm_only", "vpu_only", "replica"} <= set(times):
        noop, mm, vpu, rep = (times[k] for k in ("noop", "mm_only", "vpu_only", "replica"))
        print("\n--- derived ---")
        print(f"replica {rep:.3f} ms: loads (noop) {noop:.3f} ({noop / rep:.0%}), "
              f"contraction of H+1 planes (mm_only - noop) {mm - noop:.3f} "
              f"({(mm - noop) / rep:.0%}), planes (vpu_only - noop - one contraction) "
              f"{vpu - noop - (mm - noop) / (H + 1):.3f} "
              f"({(vpu - noop - (mm - noop) / (H + 1)) / rep:.0%})")
        if "fwd" in times:
            print(f"K1 (fwd) {times['fwd']:.3f} ms against the replica {rep:.3f} ms")
        if "mm_big" in times:
            print(f"mm_big (tensor cores) {times['mm_big']:.3f} ms against mm_only (CUDA cores) "
                  f"{mm:.3f} ms ({mm / times['mm_big']:.1f}x)")
        if "fwd_planes" in times and "fwd" in times:
            print(f"K1p (fwd_planes) {times['fwd_planes']:.3f} ms against K1 {times['fwd']:.3f} "
                  f"ms ({times['fwd_planes'] / times['fwd']:.2f}x)")
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    unknown = [a for a in argv if a not in ORDER]
    if unknown:
        raise SystemExit(f"dense_breakdown: unknown variants {unknown}; one of {', '.join(ORDER)}")
    run(tuple(argv) or ORDER)
    return 0


if __name__ == "__main__":
    sys.exit(main())
