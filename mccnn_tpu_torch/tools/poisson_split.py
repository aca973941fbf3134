"""K3, the dense Poisson sweep, split into its phases on the card.

    python -m mccnn_tpu_torch.tools.poisson_split [--no-scannet]

First (unless ``--no-scannet``) it runs ``tasks.scannet`` block evaluation
(8 x 8192) and whole-scene evaluation (the 40960 cap) through the CLI's entry
point and prints the shapes ``(B, N, r)`` of every K3 launch there: the dense
sweeps of the ScanNet hierarchy. Then, at each of ``dense_ab.poisson_sites``
(every dense sweep of a default path), it launches K3's probe build, which
stamps the end of each phase with the ``clock64`` of the last warp to reach
the barrier that closes it (``csrc/poisson_kernel.cu``), and prints, averaged
over the blocks, the cycles of the load, the same-cell links (or sort), the
27 colour steps (each split into its candidate phase and its coverage phase)
and their share of a block's span, the cheapest and the dearest colour step
(the cheapest is the per-colour floor of the chain), the device time of one
K3 launch (``device_ms``) and the span's cycles over that time. It checks that the probe's selection equals K3's and prints the
sweep's work: valid points, selected points, and the steps of the parent's
backward same-cell scan (each valid point's distance to its previous valid
point of the cell, or to index 0). It refuses to run without a CUDA device.
"""

from __future__ import annotations

import os
import sys
import tempfile
from collections import Counter

import torch

from . import card_line, device_ms, require_card


def scannet_shapes() -> Counter:
    """``(B, N, r)`` of every K3 launch in ``tasks.scannet``'s block and
    whole-scene evaluation (counted by shape)."""
    from ..ops.cuda import poisson_kernel
    from ..tasks import scannet

    seen: Counter = Counter()
    launch = poisson_kernel.poisson_sweep_cuda

    def recording(points, mask, cids, colors, radius):
        seen[(points.shape[0], points.shape[1], float(radius))] += 1
        return launch(points, mask, cids, colors, radius)

    poisson_kernel.poisson_sweep_cuda = recording
    try:
        for whole in (False, True):
            with tempfile.TemporaryDirectory() as tmp:
                argv = ["--synthetic", "--eval-only", "--batch", "8", "--points", "8192",
                        "--device", "cuda", "--log-dir", tmp, "--ckpt-dir",
                        os.path.join(tmp, "ck")]
                scannet.main(argv + (["--whole-scene-cap", "40960"] if whole else []))
    finally:
        poisson_kernel.poisson_sweep_cuda = launch
    return seen


def link_steps(mask: torch.Tensor, cids: torch.Tensor) -> tuple[float, int]:
    """Mean and largest steps of the parent's backward same-cell scan over
    the valid points: ``p - q`` for the previous valid point ``q`` of p's
    cell, ``p + 1`` where there is none."""
    B, N = mask.shape
    idx = torch.arange(N, device=mask.device).expand(B, N)
    key = torch.where(mask, cids.long(), -1) * N + idx  # invalid rows first
    order = torch.argsort(key, dim=1)
    s_cid = torch.gather(torch.where(mask, cids.long(), -1), 1, order)
    s_idx = torch.gather(idx, 1, order)
    same = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=mask.device),
                      s_cid[:, 1:] == s_cid[:, :-1]], dim=1)
    prev = torch.cat([torch.full((B, 1), -1, device=mask.device), s_idx[:, :-1]], dim=1)
    steps = torch.where(same, s_idx - prev, s_idx + 1)
    valid = torch.gather(mask, 1, order)
    steps = steps[valid].float()
    return float(steps.mean()), int(steps.max())


def split(stamps: torch.Tensor) -> dict:
    """Cycles a block of each phase from the probe's stamps (B, 64): [0] the
    start, [1] the load's end, [2] the links', [3 + 2c] colour c's
    candidates', [4 + 2c] colour c's coverage's."""
    s = stamps.double()
    col_start = s[:, 2:55:2]  # colour c begins
    col_cand = s[:, 3:56:2]  # colour c's candidates listed
    col_end = s[:, 4:57:2]  # colour c's coverage done
    colours = col_end - col_start
    return {
        "span": (s[:, 56] - s[:, 0]).mean().item(),
        "span_max": (s[:, 56] - s[:, 0]).max().item(),
        "load": (s[:, 1] - s[:, 0]).mean().item(),
        "link": (s[:, 2] - s[:, 1]).mean().item(),
        "colours": colours.sum(1).mean().item(),
        "candidates": (col_cand - col_start).sum(1).mean().item(),
        "coverage": (col_end - col_cand).sum(1).mean().item(),
        "colour_floor": colours.min(1).values.mean().item(),
        "colour_max": colours.max(1).values.mean().item(),
    }


def run(with_scannet: bool = True) -> int:
    dev = require_card("poisson_split")
    from ..core.sampling import sweep_cells
    from ..ops.cuda import poisson_kernel
    from .dense_ab import poisson_sites

    print("card:", card_line(), flush=True)
    if with_scannet:
        for (b, n, r), k in sorted(scannet_shapes().items()):
            print(f"tasks.scannet K3 launches: B={b} N={n} r={r}: {k}", flush=True)
    every = True
    for _, name, pts, mask, radius in poisson_sites(dev):
        cids, colors = sweep_cells(pts, radius)
        args = (pts, mask, cids, colors, radius)
        with torch.no_grad():
            sel = poisson_kernel.poisson_sweep_cuda(*args)
            psel, stamps = poisson_kernel.poisson_sweep_probe_cuda(*args)
            for _ in range(3):  # warm, then the last run's stamps
                psel, stamps = poisson_kernel.poisson_sweep_probe_cuda(*args)
            torch.cuda.synchronize()
            same = bool(torch.equal(sel, psel))
            every &= same
            ms = device_ms(lambda: poisson_kernel.poisson_sweep_cuda(*args), iters=10)
        sp = split(stamps)
        mean_steps, max_steps = link_steps(mask, cids)
        B, N = mask.shape
        share = {k: sp[k] / sp["span"] for k in ("load", "link", "colours", "candidates",
                                                  "coverage")}
        print(f"K3 split {name} B={B} N={N} r={radius}: valid={int(mask.sum()) / B:.0f} "
              f"selected={int(sel.sum()) / B:.1f} a cloud; parent's link scan steps mean "
              f"{mean_steps:.1f} max {max_steps}; span {sp['span']:.0f} cycles (max "
              f"{sp['span_max']:.0f}): load {sp['load']:.0f} ({share['load']:.3f}), link "
              f"{sp['link']:.0f} ({share['link']:.3f}), 27 colours {sp['colours']:.0f} "
              f"({share['colours']:.3f}: candidates {share['candidates']:.3f}, coverage "
              f"{share['coverage']:.3f}); a colour step min {sp['colour_floor']:.0f} max "
              f"{sp['colour_max']:.0f}; device_ms={ms:.4f} (span_max / device time "
              f"{sp['span_max'] / (ms * 1e3):.0f} cycles/us); probe equals K3: {same}",
              flush=True)
    print(f"K3 probe equals K3 at every site: {every}", flush=True)
    return 0 if every else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--no-scannet"]):
        raise SystemExit("usage: python -m mccnn_tpu_torch.tools.poisson_split [--no-scannet]")
    return run(with_scannet=not argv)


if __name__ == "__main__":
    sys.exit(main())
