"""T1: the dense conv's timing probes (port of the Pallas bodies of
``tools/exp_dense_breakdown.py``) — CUDA wrapper and plain versions.

The TPU tool strips K1's forward to its parts and times each on one input
set (``_prep``, ``exp_dense_breakdown.py:60-70``): B clouds of N points that
are both the samples and the sources, fp32 features cast to bf16, and
``w1`` of 8 rows (rows 0-2 meet xyz; row 3 meets the samples' |x|^2, the
fourth row of the tool's transposed sample tiles), ``b1`` (H,), ``w2`` (H,
C), ``b2`` (C,). ``VARIANTS`` are its seven kernel bodies: ``mm_only``
(``:96``), ``vpu_only`` (``:110``), ``replica`` (``:131``), ``h1``
(``:153``), ``noop`` (``:182``), ``mm_big`` (``:200``, run by ``call_big``,
one grid step a cloud) and ``fwd_bf16`` (``:234``). Two schedules hold
them. noop, mm_only and mm_big walk one staged schedule
(``csrc/dense_probe_stage.cuh``: 128-sample x 64-channel tiles over the whole
card, each block's fz resident in shared memory): noop is its loads alone
and mm_only its (H+1) contractions in fp32 FMAs (``csrc/dense_probe_staged.cu``),
mm_big the same contractions as bf16 tensor-core GEMM tiles
(``csrc/dense_probe_mm_big.cu``). vpu_only, replica, h1 and fwd_bf16 keep
K1's all-pairs schedule (``csrc/dense_probe.cu``). ``dense_probe`` picks by
device (CPU tensor -> the plain version, CUDA tensor -> the kernel) and each
variant has its own launch counter. bf16 stays bf16 where a TPU body rounds
to it.
``xla_equiv`` (``:214``), plain XLA outside any Pallas kernel in the tool,
stays ``torch.matmul`` here: it is T1's library yardstick, not a kernel.

The tool that times them on the card is ``mccnn_tpu_torch.tools.dense_breakdown``.
"""

from __future__ import annotations

import torch

from ...core.grid import pair_d2, radius_sq
from . import _build
from .dense_conv import HIDDEN, MAX_C

VARIANTS = ("mm_only", "vpu_only", "replica", "h1", "noop", "mm_big", "fwd_bf16")
W1_ROWS = 8  # the tool's w1: rows 0-2 meet xyz, row 3 |x|^2, rows 4-7 zeros

# Launches of each variant's kernel since the last reset (see density_kernel.py).
launches = {v: 0 for v in VARIANTS}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 and held in fp32."""
    return x.to(torch.bfloat16).float()


def _projections(pts, w1, radius):
    """``(cw (B, N, H), sw (B, N, H))``: ``cw = (p . w1[:3]) / r`` of the
    sources (their lanes past z are 0) and ``sw = (x . w1[:3] + |x|^2 w1[3]) /
    r`` of the samples (the tool's tile rows [x, y, z, |x|^2, 0 ...]), ``/ r``
    as the tool's ``* (1 / RADIUS)``, one rounding per op as the kernel forms
    them."""
    inv_r = torch.full((), 1.0 / radius, dtype=pts.dtype, device=pts.device)
    x, y, z = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
    base = (x * w1[0] + y * w1[1]) + z * w1[2]
    sq = (x * x + y * y) + z * z
    return base * inv_r, (base + sq * w1[3]) * inv_r


def _fold(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_h g_h * w[h]`` in h order, as the bodies' ``acc += g * w2[h]``."""
    acc = torch.zeros_like(g[0])
    for h in range(g.shape[0]):
        acc = acc + g[h] * w[h]
    return acc


def dense_probe_reference(variant: str, pts: torch.Tensor, feats: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, radius: float) -> torch.Tensor:
    """Plain PyTorch version of T1's ``variant``: ``out (B, N, C)`` from the
    tool's inputs (``pts (B, N, 3)``, ``feats (B, N, C)`` fp32, cast to bf16
    as the tool does, ``w1 (8, H)``, ``b1 (H,)``, ``w2 (H, C)``, ``b2
    (C,)``)."""
    H = w1.shape[1]
    fz = _bf16(feats)  # (B, N, C)
    if variant in ("mm_only", "mm_big"):
        a = _bf16(pts[..., 0])  # the plane stand-in: a(i, j) = bf16(x_j)
        g = (a[:, None, :] @ fz).expand(-1, pts.shape[1], -1)  # (B, M, C)
        return _fold(g.expand(H + 1, *g.shape), [w2[h % H] for h in range(H + 1)])
    if variant == "noop":
        return (torch.zeros_like(feats) + w2[0, 0]).contiguous()
    mask = (pair_d2(pts, pts) <= radius_sq(radius)).to(pts.dtype)  # (B, M samples, N sources)
    cw, sw = _projections(pts, w1, radius)
    if variant == "fwd_bf16":
        cwb = (cw + b1).to(torch.bfloat16)
        swb = sw.to(torch.bfloat16)
        pen = torch.where(mask > 0, 0.0, -1.0e9).to(torch.bfloat16)
        out = torch.zeros_like(feats)
        for h in range(H):
            pre = (cwb[:, None, :, h] - swb[:, :, None, h]) + pen  # bf16 arithmetic
            out = out + (torch.relu(pre).float() @ fz) * w2[h]
        return out + (mask @ fz) * b2
    pre = (cw[:, None, :, :] - sw[:, :, None, :]) + b1  # (B, M, N, H)
    a = torch.relu(pre) * mask[..., None]
    if variant == "vpu_only":
        run = torch.zeros_like(mask, dtype=torch.bfloat16)
        for h in range(H):
            run = run + a[..., h].to(torch.bfloat16)
        return run.float() @ fz
    if variant == "h1":
        return (_bf16(a[..., 0]) @ fz) * w2[0]
    if variant == "replica":
        out = torch.zeros_like(feats)
        for h in range(H):
            out = out + (_bf16(a[..., h]) @ fz) * w2[h]
        return out + (mask @ fz) * b2
    raise ValueError(f"unknown T1 variant {variant!r}: one of {', '.join(VARIANTS)}")


def dense_probe_cuda(variant: str, pts: torch.Tensor, feats: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     radius: float) -> torch.Tensor:
    """Launch T1's ``variant`` on CUDA tensors; the output of the plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown T1 variant {variant!r}: one of {', '.join(VARIANTS)}")
    pts, w1, b1, w2, b2 = (t.contiguous() for t in (pts, w1, b1, w2, b2))
    fz = feats.to(torch.bfloat16).contiguous()
    name = f"dense_probe ({variant})"
    _build.require_cuda(name, pts, fz, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 for t in (pts, w1, b1, w2, b2)):
        raise TypeError(f"{name}: positions and params must be float32")
    B, N, C = fz.shape
    H = w1.shape[1]
    if (H != HIDDEN or C > MAX_C or tuple(w1.shape) != (W1_ROWS, H)
            or tuple(w2.shape) != (H, C) or tuple(b2.shape) != (C,)):
        raise NotImplementedError(f"{name} is built for w1 ({W1_ROWS}, {HIDDEN}), w2 (H, C) and "
                                  f"C<={MAX_C}; got w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    out = torch.empty((B, N, C), dtype=torch.float32, device=pts.device)
    err = _build.library().dense_probe_launch(
        VARIANTS.index(variant), _build.ptr(pts), _build.ptr(fz), _build.ptr(w1), _build.ptr(b1),
        _build.ptr(w2), _build.ptr(b2), B, N, C, H, radius_sq(radius), 1.0 / radius,
        _build.ptr(out), _build.stream_of(pts))
    _build.check(err, f"dense_probe_kernel ({variant})")
    launches[variant] += 1
    return out


def staged_bytes(B: int, N: int, C: int, H: int = HIDDEN) -> int:
    """Bytes of fz and x that T1's staged schedule (noop, mm_only, mm_big)
    copies from L2 into shared memory in one call at (B, N, C, H), as the
    kernel library's ``dense_probe_staged_bytes`` counts them from the
    schedule's tile and stages (``csrc/dense_probe_stage.cuh``)."""
    n = _build.library().dense_probe_staged_bytes(B, N, C, H)
    if n < 0:
        raise OverflowError(f"dense_probe_staged_bytes: more than 2**31 bytes at {(B, N, C, H)}")
    return n


def dense_probe(variant: str, pts, feats, w1, b1, w2, b2, radius: float) -> torch.Tensor:
    """T1's ``variant``: CPU tensor -> plain version, CUDA tensor -> kernel."""
    fn = dense_probe_reference if pts.device.type == "cpu" else dense_probe_cuda
    return fn(variant, pts, feats, w1, b1, w2, b2, radius)


def xla_equiv(pts: torch.Tensor, feats: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The tool's ``xla_equiv`` (``:214``): mm_only's nine products as plain
    batched ``torch.matmul`` calls outside any kernel, T1's library
    yardstick. The operands are the bf16 values and the products are summed
    in fp32, as the tool's ``preferred_element_type=jnp.float32`` sums them
    (a bf16 ``torch.matmul`` would round its output to bf16)."""
    H = w2.shape[0]
    fz = _bf16(feats)
    a = _bf16(pts[..., 0:1]).expand(-1, -1, pts.shape[1])  # (B, N, M)
    acc = torch.zeros_like(feats)
    for h in range(H + 1):
        acc = acc + torch.matmul(a.transpose(1, 2), fz) * w2[h % H]
    return acc
