"""The cell-bucket conv at a 32k-point scene on the card, over every brick
or over the occupied ones: the port's twin of ``tools/exp_32k_bucket.py``.

    python -m mccnn_tpu_torch.tools.bucket_32k [cap] [nba]     (defaults 32 and 0)

The reference tool's scene (``tile_roofline.surface_scene`` with seed 0:
32768 points on five faces of the unit cube, B = 1), C = 128 normal
features from the same generator, r = 0.05 (R = 20), one layout at cell
capacity ``cap`` as both the sample and the source grid, and the depthwise
``bucket_mc_conv`` with ``init_mcconv_params`` (seed 0). ``nba`` is
``max_active_bricks`` (0: none, the dense sweep). It prints the layout (cap,
points dropped by overflow, R, BZ, bricks, occupied bricks), then times with
CUDA events (warm, best of several calls) one autograd forward and backward
of ``sum(out ** 2)`` with the gradients of the parameters and the features
(the reference tool's ``jax.grad(..., argnums=(0, 1))``), its points a
second, and the forward and backward kernels alone on the same layout: K9a /
K10a when NBA < the brick count, K9 / K10 otherwise. The reference tool
subtracts 30 ms of TPU host overhead from its time; no such correction is
made here. Last it prints the card and one JSON line of the launch counters
of K9, K10, K9a and K10a over the run. It refuses to run without a CUDA
device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import best_ms, card_line, require_card
from .tile_roofline import surface_scene

N, C, RADIUS = 32768, 128, 0.05


def scene(dev, cap: int, n_points: int = N) -> dict:
    """The reference tool's inputs on ``dev``: points, mask, features, pdf
    (ones), the parameters and the layout at ``cap``."""
    from ..core.buckets import build_buckets
    from ..core.mcconv import init_mcconv_params

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(surface_scene(rng, n_points))[None].to(dev)
    mask = torch.ones((1, n_points), dtype=torch.bool, device=dev)
    feats = torch.from_numpy(rng.normal(size=(1, n_points, C)).astype(np.float32)).to(dev)
    pdf = torch.ones((1, n_points), device=dev)
    params = init_mcconv_params(torch.Generator().manual_seed(0), C, None, device=dev)
    grid = build_buckets(pts, mask, RADIUS, cap)
    return dict(pts=pts, mask=mask, feats=feats, pdf=pdf, params=params, grid=grid)


def run(cap: int = 32, nba: int = 0, iters: int = 5, reps: int = 3) -> None:
    """Measure and print."""
    dev = require_card("bucket_32k")
    from ..core.mcconv import MCConvParams
    from ..ops.cuda import mcconv_kernel as mk

    s = scene(dev, cap)
    grid, mask, pdf = s["grid"], s["mask"], s["pdf"]
    R = grid.res
    bz = mk.pick_bz(R, cap)
    print(f"cap={cap} overflow={int(grid.overflow.sum())} R={R} BZ={bz} "
          f"n_blocks={mk.n_bricks(R, bz)}", flush=True)
    print(f"active bricks: {mk.count_active_bricks(grid).tolist()}", flush=True)

    max_active = nba or None
    leaves = [p.detach().requires_grad_() for p in s["params"]]
    feats = s["feats"].detach().requires_grad_()

    def fwd_bwd():
        out = mk.bucket_mc_conv(MCConvParams(*leaves), grid, mask, grid, feats, pdf,
                                max_active_bricks=max_active)
        return torch.autograd.grad(out.square().sum(), [*leaves, feats])

    fb = best_ms(fwd_bwd, iters, reps)
    active = mk.active_bricks(grid, grid, max_active)
    params = s["params"]
    wf = torch.where(mk.kept_points(grid)[..., None], s["feats"] / pdf[..., None], 0.0)
    if active is None:
        names, extra = ("K9", "K10"), ()
        fwd_k, bwd_k = mk.bucket_conv_cuda, mk.bucket_conv_backward_cuda
    else:
        names, extra = ("K9a", "K10a"), (active,)
        fwd_k, bwd_k = mk.bucket_conv_active_cuda, mk.bucket_conv_backward_active_cuda
    with torch.no_grad():
        out, cnt = fwd_k(params, grid, grid, wf, *extra)
        dout = 2 * out  # the cotangent of sum(out ** 2)
        f_ms = best_ms(lambda: fwd_k(params, grid, grid, wf, *extra), iters, reps)
        b_ms = best_ms(lambda: bwd_k(params, grid, grid, wf, cnt, dout, *extra), iters, reps)
    card = card_line()
    print(f"nba={max_active} full fwd+bwd: {fb:.4f} ms -> {N / fb / 1e3:.4f} Mpts/s ({card})",
          flush=True)
    print(f"{names[0]} alone: {f_ms:.4f} ms; {names[1]} alone: {b_ms:.4f} ms ({card})",
          flush=True)
    counts = {"K9": mk.launches, "K10": mk.backward_launches, "K9a": mk.launches_active,
              "K10a": mk.backward_launches_active}
    print("launches " + json.dumps(counts), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cap = int(argv[0]) if len(argv) > 0 else 32
    nba = int(argv[1]) if len(argv) > 1 else 0
    run(cap, nba)
    return 0


if __name__ == "__main__":
    sys.exit(main())
