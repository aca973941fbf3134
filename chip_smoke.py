#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Refuses to run without a CUDA device; turns TF32 off; prints the card's
   name and power limit (``nvidia-smi``).
2. Builds the kernels from ``mccnn_tpu_torch/csrc`` and prints the build time
   and ``ptxas``'s register / shared-memory report.
3. Holds each kernel (K1 dense MC conv, K3 Poisson sweep, K4 KDE) against its
   plain PyTorch version on the card, at every shape the MCClassS serving
   path gives it (B=8 clouds of N=1024 points), and times both with CUDA
   events.
4. Builds MCClassS(40, grow=128) with seeded weights and BN statistics and
   serves request batches of 8, 3 and 1 clouds through ``serve.Predictor``;
   checks that the logits are finite, agree with the same model on the CPU
   plain path, and that every kernel's launch counter moved while serving.
5. Prints one JSON line of kernel results, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B, N = 8, 1024
N_CLASSES, GROW = 40, 128

# Tolerances, kernel vs plain version on the card, with their reasons:
# K4: fp32 sums of up to N positive terms in another order, and the kernel's
#     expf against PyTorch's exp: bounded by about N * 2^-24 = 6e-5 relative.
KDE_RTOL = 1e-4
# K1: fp32 sums over up to N neighbours and (H+1)*C products, in another
#     order than cuBLAS's (TF32 off), relative to the site's largest output.
CONV_RTOL = 1e-4
# Served logits, card vs the CPU plain path: identical hierarchies (the d2
#     test is bit-equal), then fp32 sums in other orders through three convs
#     and three dense layers.
LOGIT_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Warm per-call time of ``fn`` on the card, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def request(rng: np.random.Generator, b: int) -> dict:
    from mccnn_tpu_torch.data.datasets import _normalize_np
    from mccnn_tpu_torch.data.synthetic import classification_batch

    pts, _ = classification_batch(rng, b, N)
    pts = np.stack([_normalize_np(p) for p in pts])
    return {"points": pts, "mask": np.ones((b, N), bool)}


def check_kernels(dev) -> dict:
    """Kernel vs plain version at the serving path's shapes."""
    from mccnn_tpu_torch.api.hierarchy import GLOBAL_RADIUS, build_hierarchy
    from mccnn_tpu_torch.core.mcconv import init_mcconv_params
    from mccnn_tpu_torch.core.sampling import sweep_cells
    from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel, poisson_kernel

    rng = np.random.default_rng(SEED)
    req = request(rng, B)
    # The serving path's levels, built by the plain path on the CPU: the
    # kernels then see exactly the shapes and padding masks they get there.
    hier = build_hierarchy(
        torch.from_numpy(req["points"]), torch.from_numpy(req["mask"]), (0.1, 0.4),
        global_level=True,
    )
    lv = [(l.points.to(dev), l.mask.to(dev)) for l in hier.levels]
    print("levels:", [tuple(p.shape[:2]) for p, _ in lv],
          "valid per cloud:", [int(m.sum(1).min()) for _, m in lv], flush=True)
    results = {"K1": [], "K3": [], "K4": []}

    with torch.inference_mode():
        pdfs = {}
        for lvl, radius in ((0, 0.2), (1, 0.8), (2, GLOBAL_RADIUS)):
            pts, mask = lv[lvl]
            got = density_kernel.kde_density_cuda(pts, mask, radius)
            want = density_kernel.kde_density_reference(pts, mask, radius)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float(((got - want).abs() / want.abs()).max())
            ms = time_ms(lambda: density_kernel.kde_density_cuda(pts, mask, radius))
            pms = time_ms(lambda: density_kernel.kde_density_reference(pts, mask, radius))
            print(f"K4 N={pts.shape[1]} r={radius:.4f}: max_abs_err={err:.3e} "
                  f"max_rel_err={rel:.3e} kernel_ms={ms:.4f} plain_ms={pms:.4f}", flush=True)
            require(bool(torch.allclose(got, want, rtol=KDE_RTOL, atol=0.0)),
                    f"K4 disagrees with its plain version at N={pts.shape[1]}")
            results["K4"].append((err, ms, pms))
            pdfs[(lvl, radius)] = want

        for lvl, radius in ((0, 0.1), (1, 0.4)):
            pts, mask = lv[lvl]
            cids, colors = sweep_cells(pts, radius)  # int32, as the kernel takes them
            got = poisson_kernel.poisson_sweep_cuda(pts, mask, cids, colors, radius)
            want = poisson_kernel.poisson_sweep_reference(pts, mask, cids, colors, radius)
            torch.cuda.synchronize()
            diff = int((got != want).sum())
            ms = time_ms(lambda: poisson_kernel.poisson_sweep_cuda(pts, mask, cids, colors, radius))
            pms = time_ms(lambda: poisson_kernel.poisson_sweep_reference(
                pts, mask, cids, colors, radius), iters=5)
            print(f"K3 N={pts.shape[1]} r={radius}: selected={int(got.sum())} "
                  f"differing_flags={diff} kernel_ms={ms:.4f} plain_ms={pms:.4f}", flush=True)
            require(diff == 0, f"K3 selection differs from its plain version at N={pts.shape[1]}")
            results["K3"].append((float(diff), ms, pms))

        gen = torch.Generator().manual_seed(SEED)
        sites = [  # (in level, out level, radius, C, CO, main path?)
            (0, 1, 0.2, 1, GROW, True),
            (1, 2, 0.8, GROW, 2 * GROW, True),
            (2, 3, GLOBAL_RADIUS, 2 * GROW, 8 * GROW, True),
            (1, 2, 0.8, GROW, None, False),  # depthwise
            (0, 1, 0.2, 1, GROW, False),  # mean mode (use_pdf=False)
        ]
        for k, (i, o, radius, c, co, main) in enumerate(sites):
            mean = k == 4
            (src, smask), (smp, qmask) = lv[i], lv[o]
            params = init_mcconv_params(gen, c, co, device=dev)
            params = params._replace(
                b1=0.1 * torch.randn(params.b1.shape, generator=gen).to(dev),
                b2=0.1 * torch.randn(params.b2.shape, generator=gen).to(dev),
            )
            feats = (torch.ones((B, src.shape[1], 1)) if c == 1 else
                     torch.randn((B, src.shape[1], c), generator=gen)).to(dev)
            pdf = torch.ones_like(src[..., 0]) if mean else pdfs[(i, radius)]
            args = (params, smp, qmask, src, smask, feats, pdf, radius)
            kw = dict(c_out=co, mean_normalize=mean, with_count=True)
            got, gcnt = dense_conv.dense_mc_conv_cuda(*args, **kw)
            want, wcnt = dense_conv.dense_mc_conv_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ms = time_ms(lambda: dense_conv.dense_mc_conv_cuda(*args, **kw))
            pms = time_ms(lambda: dense_conv.dense_mc_conv_reference(*args, **kw))
            mode = "mean" if mean else ("depthwise" if co is None else "full")
            print(f"K1 conv_{i}_{o} {mode} N={src.shape[1]} M={smp.shape[1]} C={c} "
                  f"CO={co}: max_abs_err={err:.3e} max_abs_out={scale:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={pms:.4f}", flush=True)
            require(bool(torch.equal(gcnt, wcnt)), f"K1 neighbour counts differ at conv_{i}_{o}")
            require(bool(torch.allclose(got, want, rtol=CONV_RTOL, atol=CONV_RTOL * scale)),
                    f"K1 disagrees with its plain version at conv_{i}_{o} ({mode})")
            if main:
                results["K1"].append((err, ms, pms))
    return results


def calibrate_bn(model, batch: dict, rng: np.random.Generator) -> None:
    """Seeded, non-trivial BN statistics near each BN input's real moments, so
    the logits depend on the conv outputs and not on the statistics alone."""
    from mccnn_tpu_torch.models.layers import MaskedBatchNorm
    from mccnn_tpu_torch.serve import make_predict_fn

    predict = make_predict_fn(model)
    dev = next(model.parameters()).device
    args = [torch.from_numpy(batch[k]).to(dev) for k in ("points", "mask")]
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    for bn in bns:
        seen = []
        hook = bn.register_forward_pre_hook(lambda mod, inp: seen.append(inp[0]))
        predict(*args)
        hook.remove()
        x = seen[0].reshape(-1, seen[0].shape[-1]).double()
        # the RMS sets the scale: the head's BNs see only B rows
        mean, rms = x.mean(0), x.square().mean(0).sqrt().clamp_min(1e-6)
        c = mean.shape[0]
        noise = lambda: torch.from_numpy(rng.normal(size=c)).to(dev)
        uni = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, size=c)).to(dev)
        bn.mean.copy_((mean + 0.1 * rms * noise()).float())
        bn.var.copy_((rms**2 * uni(0.5, 1.5)).float())
        with torch.no_grad():
            bn.scale.copy_(uni(0.5, 1.5).float())
            bn.bias.copy_((0.1 * noise()).float())


def serve(dev) -> tuple[dict, list]:
    from mccnn_tpu_torch.api.hierarchy import build_hierarchy
    from mccnn_tpu_torch.models import MCClassS
    from mccnn_tpu_torch.ops.cuda import dense_conv, density_kernel, poisson_kernel
    from mccnn_tpu_torch.serve import Predictor

    rng = np.random.default_rng(SEED + 1)
    model = MCClassS(N_CLASSES, grow=GROW, generator=torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    calibrate_bn(model, request(rng, B), rng)
    cpu_model = copy.deepcopy(model).cpu()
    predictor = Predictor(model, B)
    cpu_predictor = Predictor(cpu_model, B)
    requests = [request(rng, b) for b in (8, 3, 1, 8, 3, 1)]
    torch.cuda.synchronize()

    modules = {"K1": dense_conv, "K3": poisson_kernel, "K4": density_kernel}
    for m in modules.values():
        m.launches = 0
    served, latencies = [], []
    for req in requests:
        t0 = time.perf_counter()
        logits = predictor.predict(req)
        torch.cuda.synchronize()
        latencies.append((len(req["points"]), (time.perf_counter() - t0) * 1e3))
        served.append(logits)
    launches = {k: m.launches for k, m in modules.items()}
    print("launches while serving:", launches, flush=True)
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched while serving")

    for req, logits, (b, ms) in zip(requests, served, latencies):
        want = cpu_predictor.predict(req)
        got = logits.cpu()
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        with torch.inference_mode():
            h_gpu = build_hierarchy(torch.from_numpy(req["points"]).to(dev),
                                    torch.from_numpy(req["mask"]).to(dev), (0.1, 0.4))
            h_cpu = build_hierarchy(torch.from_numpy(req["points"]),
                                    torch.from_numpy(req["mask"]), (0.1, 0.4))
        same_levels = all(
            torch.equal(a.sample.idx.cpu(), c.sample.idx) and torch.equal(a.mask.cpu(), c.mask)
            for a, c in zip(h_gpu.levels[1:], h_cpu.levels[1:])
        )
        print(f"served batch of {b}: latency_ms={ms:.3f} logits={tuple(got.shape)} "
              f"max_abs_err_vs_cpu={err:.3e} max_abs_logit={top:.3e} "
              f"hierarchy_equal_to_cpu={same_levels}", flush=True)
        require(tuple(got.shape) == (b, N_CLASSES), f"logits shape {tuple(got.shape)}")
        require(bool(torch.isfinite(got).all()), "non-finite logits")
        require(same_levels, "the card's hierarchy differs from the CPU plain path's")
        require(bool(torch.allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_RTOL * top)),
                "served logits disagree with the CPU plain path")
    return launches, latencies


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mccnn_tpu_torch.ops.cuda import _build

    card = card_line()
    print("card:", card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "python",
          sys.version.split()[0], flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s): {lib.path}", flush=True)
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    results = check_kernels(dev)
    launches, _ = serve(dev)

    meta = {
        "K1": ("dense_mc_conv", "mccnn_tpu_torch/csrc/dense_conv.cu",
               "mccnn_tpu/ops/pallas/dense_conv.py:360"),
        "K3": ("poisson_sweep", "mccnn_tpu_torch/csrc/poisson_kernel.cu",
               "mccnn_tpu/ops/pallas/poisson_kernel.py:41"),
        "K4": ("kde_density", "mccnn_tpu_torch/csrc/density_kernel.cu",
               "mccnn_tpu/ops/pallas/density_kernel.py:34"),
    }
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        rows = results[kid]
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kid],
            "max_abs_err": max(r[0] for r in rows),
            "ms": sum(r[1] for r in rows),
            "plain_ms": sum(r[2] for r in rows),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
