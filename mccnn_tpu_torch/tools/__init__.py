"""Measurement tools of the port, run on the card (``python -m
mccnn_tpu_torch.tools.<name>``): the twins of the reference's roofline tools.

- ``tile_roofline``: the tile kernels (K5, K6) stripped by their probes, at a
  32k-point scene (``tools/exp_tile_roofline.py``'s twin).
- ``dense_breakdown``: the dense forward (K1) stripped by T1's variants, at B =
  8 x 1024 (``tools/exp_dense_breakdown.py``'s twin).
- ``bucket_32k``: the bucket conv (K9 / K10, or K9a / K10a over the occupied
  bricks) at a 32k-point scene (``tools/exp_32k_bucket.py``'s twin).

Nothing of the package's main path imports them. They refuse to run without
a CUDA device: every number they print is a time on the card.
"""

from __future__ import annotations

import subprocess

import torch

# The H100's published peaks (NVIDIA H100 SXM data sheet, 700 W, dense):
# device memory bandwidth, fp32 outside the tensor cores, TF32 and bf16
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12


def require_card(tool: str) -> torch.device:
    """The CUDA device, or a ``SystemExit``: the tools have no CPU mode."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; this tool times kernels on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def best_ms(fn, iters: int = 5, reps: int = 3) -> float:
    """Warm per-call time of ``fn`` on the card: CUDA events around ``iters``
    calls, the best of ``reps`` such runs."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_ms(fn, iters: int = 5, reps: int = 3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, the graph replayed between CUDA events, the best of ``reps``
    replays. Unlike ``best_ms``, a call that costs the card a few
    microseconds does not read as its host dispatch. A launch that cannot
    be captured raises."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best
