"""Where the dense conv's time goes on the card: the port's twin of
``tools/exp_dense_breakdown.py``.

    python -m mccnn_tpu_torch.tools.dense_breakdown [name ...]     (default: all)

At the reference tool's shapes (B = 8 clouds, N = M = 1024 points that are
both samples and sources, C = 128, H = 8, r = 0.2; uniform points, normal
features, seed 0) it times (warm, best of several runs):

- ``fwd`` / ``layer``: the dense conv's forward (K1 and its projection,
  through ``dense_mc_conv``) and forward + backward (K1, K2), depthwise;
- ``fwd_planes``: the same forward with K1p (``MCCNN_DENSE_PLANES=mxu``);
- T1's variants (``ops/cuda/dense_probe.py``): ``replica``, ``mm_only``,
  ``vpu_only``, ``h1``, ``noop``, ``mm_big``, ``fwd_bf16``;
- ``xla_equiv``: mm_only's products as plain ``torch.matmul`` calls, and
  ``torch_full``: one ``torch.full`` of noop's output, the library calls.

Each gets its call time (``best_ms``: back-to-back calls, which reads a call
that costs the card a few microseconds as its host dispatch); T1's variants
and the library calls also their device time (``device_ms``: the calls
replayed from a CUDA graph), T1's with the wrapper's bf16 cast and of the
kernel alone (features given in bf16), in a second pass after every call
time. The variants share two schedules:
noop, mm_only and mm_big walk the staged one (``csrc/dense_probe_stage.cuh``);
replica, vpu_only, h1 and fwd_bf16 K1's all-pairs one. ``split`` reads the
forward's parts from the kernels' device times, each from variants of one
schedule. Beside each variant stand two floors on the H100, each the larger
of its fp32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s (NVIDIA
H100 SXM data sheet; mm_big's walked work, which runs on the tensor cores,
over their 989 TFLOP/s bf16 peak): the *function's* floor (``t1_ops``: d2
over every pair, planes and contractions over the in-radius pairs this
run's points hold, one contraction where the planes are one plane;
``t1_bytes``: the inputs the variant reads and its output) and the
*walked-work* floor (the same work over every pair, as the kernels walk
them). It refuses to run without a CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import (PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S, PEAK_FP32_FLOP_PER_S, best_ms,
               device_ms, require_card)

B, N, M, C, H = 8, 1024, 1024, 128, 8
RADIUS = 0.2
ORDER = ("fwd", "layer", "fwd_planes", "replica", "mm_only", "vpu_only", "h1", "noop", "mm_big",
         "xla_equiv", "torch_full", "fwd_bf16")


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


def split(times: dict) -> dict:
    """The dense forward's parts that ``times`` (name -> ms) give, each read
    from variants of one schedule. The staged one (noop, mm_only, mm_big):
    ``loads`` = noop, ``cuda_core_contraction`` = mm_only - noop,
    ``tensor_core_contraction`` = mm_big - noop, and ``cuda_over_tensor``,
    their ratio. K1's all-pairs one, where h1 = loads + one plane + one
    contraction, vpu_only = loads + H planes + one contraction and replica =
    loads + H planes (and the mask) + H + 1 contractions:
    ``k1_contraction`` = (replica - vpu_only) / H, ``k1_plane`` = (vpu_only -
    h1) / (H - 1), ``k1_loads`` = h1 - both."""
    out = {}
    if {"noop", "mm_only", "mm_big"} <= times.keys():
        out["loads"] = times["noop"]
        out["cuda_core_contraction"] = times["mm_only"] - times["noop"]
        out["tensor_core_contraction"] = times["mm_big"] - times["noop"]
        out["cuda_over_tensor"] = out["cuda_core_contraction"] / out["tensor_core_contraction"]
    if {"replica", "vpu_only", "h1"} <= times.keys():
        out["k1_contraction"] = (times["replica"] - times["vpu_only"]) / H
        out["k1_plane"] = (times["vpu_only"] - times["h1"]) / (H - 1)
        out["k1_loads"] = times["h1"] - out["k1_plane"] - out["k1_contraction"]
    return out


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


def run(names=ORDER, iters: int = 5, reps: int = 3, calls_timed=None) -> dict:
    """Time and print ``names``; returns {name: ms}, the device time of the
    kernel alone where one was taken (T1's variants), of the call for the
    library calls, else the call time. Every call time is taken first, then
    ``calls_timed()`` is called (if given), then the device times: a graph
    capture passes through the wrappers' launch counters without launching,
    and its replays launch without passing them, so counters read in
    ``calls_timed`` count the calls that launched."""
    dev = require_card("dense_breakdown")
    from ..core.mcconv import init_mcconv_params
    from ..ops.cuda import dense_conv, dense_probe

    pts, feats, w1, b1, w2, b2 = inputs(dev)
    fzb = feats.to(torch.bfloat16)  # the kernels alone: the wrapper's cast is then a no-op
    mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    pdf = torch.ones((B, N), device=dev)
    params = init_mcconv_params(torch.Generator().manual_seed(0), C, None, device=dev)
    wf = dense_conv._weighted_features(feats, pdf, mask)
    conv = (params, pts, mask, pts, mask, wf, RADIUS, None, False)
    fill = float(w2[0, 0])

    def layer():
        f = feats.detach().requires_grad_()
        out = dense_conv.dense_mc_conv(params, pts, mask, pts, mask, f, pdf, RADIUS)
        out.square().sum().backward()

    t1 = {v: (lambda f, v=v: dense_probe.dense_probe_cuda(v, pts, f, w1, b1, w2, b2, RADIUS))
          for v in dense_probe.VARIANTS}
    fns = {"fwd": lambda: dense_conv._forward_cuda(*conv),
           "layer": layer,
           "fwd_planes": lambda: dense_conv.dense_mc_conv_planes_cuda(*conv),
           "xla_equiv": lambda: dense_probe.xla_equiv(pts, feats, w2),
           "torch_full": lambda: torch.full((B, N, C), fill, device=dev)}
    fns.update({v: (lambda f=f: f(feats)) for v, f in t1.items()})
    pairs, inr = B * M * N, in_radius_pairs(pts)
    print(f"B={B} N=M={N} C={C} H={H} r={RADIUS}: {pairs} pairs, {inr} in radius "
          f"({inr / pairs:.1%}); the staged schedule copies "
          f"{dense_probe.staged_bytes(B, N, C, H)} bytes a call", flush=True)
    times = {name: best_ms(fns[name], iters, reps) for name in names}
    if calls_timed is not None:
        calls_timed()
    for name in names:
        line = f"{name:13s} call {times[name]:8.4f} ms"
        if name in t1 or name in ("xla_equiv", "torch_full"):
            times[name] = device_ms(fns[name], iters, reps)
            line += f"   device {times[name]:8.4f} ms"
        if name in t1:
            times[name] = device_ms(lambda: t1[name](fzb), iters, reps)
            floor, walked = t1_floor(name, pairs, inr), t1_floor(name, pairs, inr, walked=True)
            line += (f" (kernel alone {times[name]:.4f})   floor {floor:.4f} ms "
                     f"({times[name] / floor:.0f}x)   walked-work floor {walked:.4f} ms "
                     f"({times[name] / walked:.2f}x)")
        print(line, flush=True)
    parts = split(times)
    print("\n--- derived (device times of the kernels alone) ---")
    if "loads" in parts:
        print(f"staged schedule: loads (noop) {parts['loads']:.4f} ms, CUDA-core contraction "
              f"(mm_only - noop) {parts['cuda_core_contraction']:.4f}, tensor-core contraction "
              f"(mm_big - noop) {parts['tensor_core_contraction']:.4f}: "
              f"{parts['cuda_over_tensor']:.2f}x", flush=True)
    if "k1_loads" in parts:
        print(f"K1's all-pairs schedule: replica {times['replica']:.4f} ms = loads "
              f"{parts['k1_loads']:.4f} + {H} planes of {parts['k1_plane']:.4f} + {H + 1} "
              f"contractions of {parts['k1_contraction']:.4f}", flush=True)
    if {"mm_only", "xla_equiv"} <= times.keys():
        print(f"mm_only {times['mm_only']:.4f} ms against xla_equiv {times['xla_equiv']:.4f} ms "
              f"({times['mm_only'] / times['xla_equiv']:.2f}x)", flush=True)
    if {"mm_only", "mm_big"} <= times.keys():
        print(f"mm_big (tensor cores) {times['mm_big']:.4f} ms against mm_only (CUDA cores) "
              f"{times['mm_only']:.4f} ms ({times['mm_only'] / times['mm_big']:.2f}x)", flush=True)
    if {"fwd", "replica"} <= times.keys():
        print(f"K1 (fwd, call) {times['fwd']:.3f} ms against the replica {times['replica']:.3f} ms")
    if {"fwd_planes", "fwd"} <= times.keys():
        print(f"K1p (fwd_planes) {times['fwd_planes']:.3f} ms against K1 {times['fwd']:.3f} "
              f"ms ({times['fwd_planes'] / times['fwd']:.2f}x)")
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    unknown = [a for a in argv if a not in ORDER]
    if unknown:
        raise SystemExit(f"dense_breakdown: unknown names {unknown}; one of {', '.join(ORDER)}")
    run(tuple(argv) or ORDER)
    return 0


if __name__ == "__main__":
    sys.exit(main())
