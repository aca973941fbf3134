"""K1 and K2: the dense Monte-Carlo convolution, forward and backward — CUDA
wrappers, plain versions and the autograd Function that joins them.

K1 replaces ``mccnn_tpu/ops/pallas/dense_conv.py::_fwd_kernel_b`` (reached
through ``_fwd_call_b`` and ``dense_mc_conv``), with the same value as the
reference's ``dense_mc_conv`` (``dense_conv.py:803-866``): every valid source
within ``radius`` of a sample contributes, with no neighbour capacity. K2
replaces its backward, ``_bwd_kernel_b`` (``:422``, called at ``:693`` from the
``custom_vjp`` at ``:747-792``).

The kernels are ``mccnn_tpu_torch/csrc/dense_conv.cu`` (K1) and
``dense_conv_bwd.cu`` (K2). Unlike the TPU kernel, which folds W2 into the
features before its one wide MXU product, K1 contracts over the neighbours
first (the bilinear factorisation of ``mccnn_tpu/core/mcconv.py:98-126``): a
pair kernel forms ``G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c]`` and a projection
kernel applies (W2, b2). The forward keeps G for the backward, whose GEMM
parts (dG, dW2) and pair parts (d_f~, dW1, db1) split the same way. Both pair
kernels test every pair's d2 and form planes and FMAs only for the in-radius
pairs of valid points: a block sweeps the other side of the pair and builds,
per owned point, the list of its in-radius partners with warp ballots
(``csrc/dense_pairs.cuh``); K2 reads dG rows only for listed pairs. Every
output keeps one writer and adds its terms in increasing index, so G and
d_f~ are what the all-pairs kernels gave, bit for bit (see the sources'
headers). Everything is fp32.

K1v1 and K2v1 replace the reference's per-h variant of the same pair,
``_fwd_kernel`` (``:99``, called at ``:584``) and ``_bwd_kernel`` (``:129``,
called at ``:617``), which ``MCCNN_DENSE_V1=1`` selects (``:735-736``). They
compute K1's and K2's function and keep no G between them: K1v1
(``csrc/dense_conv_v1.cu``) forms each sample tile's G from the same
in-radius lists and folds it into (W2, b2) in the block that formed it;
K2v1 (``csrc/dense_conv_v1_bwd.cu``) forms G's rows again with K1v1's tile
kernel into a transient buffer and runs K2's GEMMs and pair kernel on them.
Their plain versions are ``dense_mc_conv_reference`` and
``dense_mc_conv_v1_backward_reference``.

K1p replaces ``_plane_fill_mxu`` (``:314``), which ``MCCNN_DENSE_PLANES=mxu``
(``:357``) puts in place of the plane fill of the v2 forward
``_fwd_kernel_b`` (``:409``): the pre-activations in the factored form
``pre_h(i, j) = (cw_h(j) - sw_h(i)) + b1_h`` (``cw = (p_j . W1) / r``, ``sw
= (x_i . W1) / r``), formed on the tensor cores for the pairs of K1's
in-radius lists (``csrc/dense_conv_planes.cu``, K1's pair kernel with that
step changed). It computes K1's function and keeps its G; the backward stays
K2, as the reference's stays ``_bwd_kernel_b``. Its plain version is
``dense_mc_conv_planes_reference``.

``dense_mc_conv`` routes through ``DenseMCConvFunction`` on both devices:
K1 / K2 for CUDA tensors, the plain versions for CPU tensors. With
``MCCNN_DENSE_V1=1`` in the environment when this module is imported
(``_USE_V1``, read at call time, as the reference reads its flag) it routes
through ``DenseMCConvV1Function`` instead: K1v1 / K2v1 for CUDA tensors, the
plain versions for CPU tensors. With ``MCCNN_DENSE_PLANES=mxu`` (``_PLANES_MXU``)
and without v1, ``DenseMCConvFunction`` forms its forward with K1p on CUDA
tensors and its plain version on CPU tensors. The Function
differentiates with respect to the weighted features ``f~ = features / pdf``
and the kernel MLP; ``features / pdf`` stays outside it, so autograd carries
``d_f~`` on to the features. Positions, masks and the pdf get no gradient
through the Function, as the reference's ``_core_bwd`` returns zeros for them.
"""

from __future__ import annotations

import functools
import os

import torch

from ...core.grid import pair_d2, radius_sq
from ...core.mcconv import MCConvParams
from . import _build

MAX_C = 1024  # the pair kernels hold C in 256 threads of 4 channels
HIDDEN = 8  # the pair kernels' accumulators are unrolled for H = 8
_TARGET_BLOCKS = 264  # two blocks per SM of an H100 for the split-K dW2 GEMM
_REDUCE_SPLIT = 256  # rows of the second pass of a two-pass partial-sum reduction

# The reference's variant switch (mccnn_tpu/ops/pallas/dense_conv.py:735-736):
# read once here, consulted at every call.
_USE_V1 = os.environ.get("MCCNN_DENSE_V1") == "1"
# K1p's switch (dense_conv.py:357): the v2 forward's planes on the tensor cores.
_PLANES_MXU = os.environ.get("MCCNN_DENSE_PLANES") == "mxu"

# Launches of K1, K2, K1v1, K2v1 and K1p since the last reset (see density_kernel.py).
launches = 0
backward_launches = 0
launches_v1 = 0
backward_launches_v1 = 0
launches_planes = 0


def _weighted_features(features, pdf, source_mask):
    """``features / pdf``, masked to 0 (``dense_conv.py:837-838``)."""
    return torch.where(source_mask[..., None], features / pdf[..., None], 0.0)


def _scale(cnt, sample_mask, mean_normalize):
    """Per-sample output factor: 1/count in mean mode, 0 for masked samples.
    The backward scales ``dout`` by the same factor (``dense_conv.py:770-773``:
    ``1/cnt`` where ``cnt >= 1``, and a sample with no neighbour has G = 0)."""
    s = 1.0 / cnt.clamp_min(1.0) if mean_normalize else torch.ones_like(cnt)
    return torch.where(sample_mask, s, 0.0)


def _in_radius(sample_pts, sample_mask, source_pts, source_mask, radius):
    return (
        (pair_d2(sample_pts, source_pts) <= radius_sq(radius))
        & source_mask[:, None, :]
        & sample_mask[:, :, None]
    )  # (B, M, N)


def _offsets(sample_pts, source_pts, radius):
    return (source_pts[:, None, :, :] - sample_pts[:, :, None, :]) / radius  # (B, M, N, 3)


def _kernel_preact(off, w1, b1):
    """``pre_h`` rounded as ``common.cuh::mc_preact`` forms it on the card,
    ``fma(oz, w1z, fma(oy, w1y, ox * w1x)) + b1``, each fused multiply-add in
    float64 and rounded once: the backward's ReLU step ``pre > 0`` then falls
    the same way in a kernel and in its plain version, even for a pair whose
    ``pre`` is within an ulp of 0."""
    d = torch.float64
    x = off[..., 0:1] * w1[0]
    y = (off[..., 1:2].to(d) * w1[1].to(d) + x.to(d)).to(off.dtype)
    z = (off[..., 2:3].to(d) * w1[2].to(d) + y.to(d)).to(off.dtype)
    return z + b1


def _pair_terms(params, sample_pts, sample_mask, source_pts, source_mask, radius,
                kernel_rounding=False):
    """``(in radius (B, M, N), offsets (B, M, N, 3), pre (B, M, N, H))``.
    ``kernel_rounding`` forms the offsets by a division by a device tensor and
    pre as ``mc_preact`` (``_kernel_preact``), so the ReLU steps fall as in
    the kernels."""
    inr = _in_radius(sample_pts, sample_mask, source_pts, source_mask, radius)
    if not kernel_rounding:
        off = _offsets(sample_pts, source_pts, radius)
        return inr, off, off @ params.w1 + params.b1
    r = torch.full((), float(radius), dtype=sample_pts.dtype, device=sample_pts.device)
    off = (source_pts[:, None, :, :] - sample_pts[:, :, None, :]) / r
    return inr, off, _kernel_preact(off, params.w1, params.b1)


def _forward_reference(params, sample_pts, sample_mask, source_pts, source_mask, wf,
                       radius, c_out, mean_normalize, factored=False):
    """Plain forward from the weighted features: ``(out, cnt, G)``; with
    ``factored`` K1p's, pre_h in the factored form (``_factored_preact``)."""
    inr = _in_radius(sample_pts, sample_mask, source_pts, source_mask, radius)
    pre = (_factored_preact(sample_pts, source_pts, params.w1, params.b1, radius) if factored
           else _offsets(sample_pts, source_pts, radius) @ params.w1 + params.b1)
    act = torch.relu(pre)
    a = torch.cat([act, torch.ones_like(act[..., :1])], dim=-1) * inr[..., None]
    G = torch.einsum("bmnh,bnc->bmhc", a, wf)  # (B, M, H+1, C)
    cnt = inr.sum(dim=-1).to(wf.dtype)
    return project_reference(params, G, cnt, sample_mask, c_out, mean_normalize), cnt, G


def project_reference(params, G, cnt, sample_mask, c_out, mean_normalize):
    """The plain projection of ``G (B, M, H+1, C)`` by (W2, b2), scaled per
    sample (the dense and the tile conv share it)."""
    H = params.w1.shape[1]
    if c_out is None:
        out = (G[:, :, :H] * params.w2).sum(dim=2) + G[:, :, H] * params.b2
    else:
        B, M, _, C = G.shape
        out = G[:, :, :H].reshape(B, M, H * C) @ params.w2.reshape(H * C, c_out)
        out = out + G[:, :, H] @ params.b2.reshape(C, c_out)
    return out * _scale(cnt, sample_mask, mean_normalize)[..., None]


def dense_mc_conv_reference(
    params: MCConvParams,
    sample_pts: torch.Tensor,
    sample_mask: torch.Tensor,
    source_pts: torch.Tensor,
    source_mask: torch.Tensor,
    features: torch.Tensor,
    pdf: torch.Tensor,
    radius: float,
    *,
    c_out: int | None = None,
    mean_normalize: bool = False,
    with_count: bool = False,
):
    """Plain PyTorch version of K1: the same neighbours-first contraction, all pairs.

    Returns ``out (B, M, C | c_out)``, and the in-radius count ``(B, M)`` when
    ``with_count``.
    """
    wf = _weighted_features(features, pdf, source_mask)
    out, cnt, _ = _forward_reference(params, sample_pts, sample_mask, source_pts,
                                     source_mask, wf, radius, c_out, mean_normalize)
    return (out, cnt) if with_count else out


def _factored_preact(sample_pts, source_pts, w1, b1, radius):
    """K1p's pre-activations ``(B, M, N, H)``: ``(cw_h(j) - sw_h(i)) + b1_h``
    with ``cw = (p_j . W1) / r`` and ``sw = (x_i . W1) / r``, the factored form
    of the reference's ``_plane_fill_mxu`` (``dense_conv.py:334-345``). The
    projections round as ``csrc/common.cuh::mc_w1_proj`` forms them
    (one rounding per op, a division by a device tensor); the kernel sums
    ``cw - sw + b1`` on the tensor cores."""
    r = torch.full((), float(radius), dtype=sample_pts.dtype, device=sample_pts.device)

    def proj(p):
        return ((p[..., 0:1] * w1[0] + p[..., 1:2] * w1[1]) + p[..., 2:3] * w1[2]) / r

    return (proj(source_pts)[:, None, :, :] - proj(sample_pts)[:, :, None, :]) + b1


def _forward_planes_reference(*args):
    """K1p's plain forward from the weighted features: ``(out, cnt, G)``."""
    return _forward_reference(*args, factored=True)


def dense_mc_conv_planes_reference(
    params: MCConvParams,
    sample_pts: torch.Tensor,
    sample_mask: torch.Tensor,
    source_pts: torch.Tensor,
    source_mask: torch.Tensor,
    features: torch.Tensor,
    pdf: torch.Tensor,
    radius: float,
    *,
    c_out: int | None = None,
    mean_normalize: bool = False,
    with_count: bool = False,
):
    """Plain PyTorch version of K1p: ``dense_mc_conv_reference``'s arguments
    and value, with the pre-activations in the factored form of
    ``_factored_preact``."""
    wf = _weighted_features(features, pdf, source_mask)
    out, cnt, _ = _forward_planes_reference(params, sample_pts, sample_mask, source_pts,
                                            source_mask, wf, radius, c_out, mean_normalize)
    return (out, cnt) if with_count else out


def _forward_cuda(params, sample_pts, sample_mask, source_pts, source_mask, wf, radius,
                  c_out, mean_normalize, planes=False):
    """Launch K1 (pair kernel + projection kernel), or with ``planes`` K1p's
    pair kernel and the same projection: ``(out, cnt, G)``."""
    global launches, launches_planes
    w1, b1, w2, b2 = (t.contiguous() for t in params)
    sample_pts, sample_mask = sample_pts.contiguous(), sample_mask.contiguous()
    source_pts, source_mask = source_pts.contiguous(), source_mask.contiguous()
    wf = wf.contiguous()
    name = "dense_mc_conv (K1p)" if planes else "dense_mc_conv (K1)"
    _build.require_cuda(name, sample_pts, sample_mask, source_pts, source_mask, wf,
                        w1, b1, w2, b2)
    if any(t.dtype != torch.float32 for t in (sample_pts, source_pts, wf, w1, b1, w2, b2)):
        raise TypeError(f"{name}: positions, features and params must be float32")
    B, M, _ = sample_pts.shape
    N = source_pts.shape[1]
    C = wf.shape[-1]
    H = w1.shape[1]
    if H != HIDDEN or C > MAX_C:
        raise NotImplementedError(
            f"{name} is built for H={HIDDEN} and C<={MAX_C}; got H={H}, C={C}"
        )
    dev = sample_pts.device
    new = torch.zeros if B * M == 0 or N == 0 else torch.empty  # the kernels write every value
    out = new((B, M, C if c_out is None else c_out), dtype=torch.float32, device=dev)
    cnt = new((B, M), dtype=torch.float32, device=dev)
    G = new((B, M, H + 1, C), dtype=torch.float32, device=dev)
    if B * M == 0 or N == 0:
        return out, cnt, G
    lib = _build.library()
    stream = _build.stream_of(sample_pts)
    args = (_build.ptr(sample_pts), _build.ptr(sample_mask), _build.ptr(source_pts),
            _build.ptr(source_mask), _build.ptr(wf), _build.ptr(w1), _build.ptr(b1),
            B, M, N, C, H, radius_sq(radius), float(radius), _build.ptr(G), _build.ptr(cnt))
    if planes:  # K1p's scratch: three TF32 pieces of cw_h / -sw_h a point and h
        pieces = torch.empty((B * (M + N) * 3 * H,), dtype=torch.int32, device=dev)
        err = lib.mcconv_planes_pair_launch(*args, _build.ptr(pieces), stream)
    else:
        err = lib.mcconv_pair_launch(*args, stream)
    _build.check(err, "mcconv_planes_pair_kernel" if planes else "mcconv_pair_kernel")
    scale = _scale(cnt, sample_mask, mean_normalize).contiguous()
    if c_out is None:
        err = lib.mcconv_project_depthwise_launch(
            _build.ptr(G), _build.ptr(w2), _build.ptr(b2), _build.ptr(scale),
            B * M, H, C, _build.ptr(out), stream,
        )
        _build.check(err, "mcconv_project_depthwise_kernel")
    else:
        project_full(G, w2, b2, scale, B * M, (H + 1) * C, H * C, c_out, out,
                     "mcconv_project_full_kernel")
    if planes:
        launches_planes += 1
    else:
        launches += 1
    return out, cnt, G


def dense_mc_conv_planes_cuda(params, sample_pts, sample_mask, source_pts, source_mask, wf,
                              radius, c_out=None, mean_normalize=False):
    """Launch K1p (its pair kernel, then K1's projection): ``(out, cnt, G)``
    from the weighted features, as ``_forward_planes_reference``."""
    return _forward_cuda(params, sample_pts, sample_mask, source_pts, source_mask, wf, radius,
                         c_out, mean_normalize, planes=True)


# ------------------------------------------------------------------ backward


def dense_mc_conv_backward_reference(
    params: MCConvParams,
    sample_pts: torch.Tensor,
    sample_mask: torch.Tensor,
    source_pts: torch.Tensor,
    source_mask: torch.Tensor,
    wf: torch.Tensor,
    radius: float,
    G: torch.Tensor,
    cnt: torch.Tensor,
    dout: torch.Tensor,
    *,
    c_out: int | None = None,
    mean_normalize: bool = False,
):
    """Plain PyTorch version of K2.

    From the forward's inputs (``wf`` = the weighted features), its ``G (B, M,
    H+1, C)`` and count, and ``dout (B, M, C | c_out)``, returns ``(d_wf (B, N,
    C), dw1 (3, H), db1 (H,), dw2, db2)`` in the shapes of ``MCConvParams``.
    """
    t = dout * _scale(cnt, sample_mask, mean_normalize)[..., None]
    terms = _pair_terms(params, sample_pts, sample_mask, source_pts, source_mask, radius)
    return _backward_reference(params, *terms, wf, G, t, c_out)


def _backward_reference(params, inr, off, pre, wf, G, t, c_out):
    """K2's plain backward from the pair terms, G and ``t = s * dout``."""
    w1, b1, w2, b2 = params
    H = w1.shape[1]
    B, M, H1, C = G.shape
    if c_out is None:
        dG = torch.cat([t[:, :, None, :] * w2, (t * b2)[:, :, None, :]], dim=2)
        dw2 = (G[:, :, :H] * t[:, :, None, :]).sum(dim=(0, 1))
        db2 = (G[:, :, H] * t).sum(dim=(0, 1))
    else:
        wcat = torch.cat([w2.reshape(H * C, c_out), b2.reshape(C, c_out)])
        tr = t.reshape(B * M, c_out)
        dG = (tr @ wcat.T).reshape(B, M, H1, C)
        dwcat = G.reshape(B * M, H1 * C).T @ tr
        dw2 = dwcat[: H * C].reshape(w2.shape)
        db2 = dwcat[H * C :].reshape(b2.shape)
    a = torch.cat([torch.relu(pre), torch.ones_like(pre[..., :1])], dim=-1) * inr[..., None]
    d_wf = torch.einsum("bmnh,bmhc->bnc", a, dG)
    dpre = torch.einsum("bmhc,bnc->bmnh", dG[:, :, :H], wf)
    dpre = torch.where((pre > 0) & inr[..., None], dpre, 0.0)  # the step at pre == 0 is 0
    dw1 = torch.einsum("bmnh,bmnk->kh", dpre, off)
    db1 = dpre.sum(dim=(0, 1, 2))
    return d_wf, dw1, db1, dw2, db2


def _split_rows(R: int, tiles: int) -> tuple[int, int]:
    """(chunks, rows per chunk) of a row-split reduction: enough blocks to
    fill the card, at least 128 rows per chunk."""
    splits = max(1, min(-(-R // 128), -(-_TARGET_BLOCKS // max(tiles, 1))))
    rchunk = -(-R // splits)
    rchunk = -(-rchunk // 16) * 16
    return -(-R // rchunk), rchunk


def dense_mc_conv_backward_cuda(
    params: MCConvParams,
    sample_pts: torch.Tensor,
    sample_mask: torch.Tensor,
    source_pts: torch.Tensor,
    source_mask: torch.Tensor,
    wf: torch.Tensor,
    radius: float,
    G: torch.Tensor,
    cnt: torch.Tensor,
    dout: torch.Tensor,
    *,
    c_out: int | None = None,
    mean_normalize: bool = False,
):
    """Launch K2 on CUDA tensors; the arguments and outputs of the plain version."""
    global backward_launches
    grads = _backward_cuda("dense_mc_conv_backward_cuda", params, sample_pts, sample_mask,
                           source_pts, source_mask, wf, radius, cnt, dout, c_out,
                           mean_normalize, G)
    backward_launches += 1
    return grads


@functools.lru_cache(maxsize=256)
def _pair_blocks(B: int, N: int, M: int, C: int) -> int:
    """K2's pair-kernel partial rows for a batch shape (0: refused)."""
    return _build.library().mcconv_bwd_pair_blocks(B, N, M, C)


def _backward_cuda(name, params, sample_pts, sample_mask, source_pts, source_mask, wf, radius,
                   cnt, dout, c_out, mean_normalize, G=None):
    """K2's launches: the dG GEMM (full), the row-split [dW2; db2] GEMM over
    G, the pair kernel (d_wf and the dW1 / db1 partials) and their reduction,
    on ``t = s * dout``. With ``G=None`` (K2v1) G's rows are formed again
    first by K1v1's tile kernel (``mcconv_v1_g_launch``), which also writes t,
    into a buffer freed after the dW2 GEMM."""
    w1, b1, w2, b2 = (t.contiguous() for t in params)
    sample_pts, sample_mask = sample_pts.contiguous(), sample_mask.contiguous()
    source_pts, source_mask = source_pts.contiguous(), source_mask.contiguous()
    wf, cnt, dout = wf.contiguous(), cnt.contiguous(), dout.contiguous()
    given = () if G is None else (G.contiguous(),)
    floats = (sample_pts, source_pts, wf, w1, b1, w2, b2, cnt, dout, *given)
    _build.require_cuda(name, sample_mask, source_mask, *floats)
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError(f"{name}: positions, features, params, G, counts and dout must be "
                        "float32")
    B, M, _ = sample_pts.shape
    N = source_pts.shape[1]
    H = w1.shape[1]
    C = wf.shape[-1]
    H1 = H + 1
    CO = C if c_out is None else c_out
    if H != HIDDEN or C > MAX_C:
        raise NotImplementedError(f"{name} is built for H={HIDDEN} and C<={MAX_C}; "
                                  f"got H={H}, C={C}")
    if (tuple(cnt.shape) != (B, M) or tuple(dout.shape) != (B, M, CO)
            or (G is not None and tuple(G.shape) != (B, M, H1, C))):
        raise ValueError(f"{name}: cnt {tuple(cnt.shape)} / dout {tuple(dout.shape)}"
                         + ("" if G is None else f" / G {tuple(G.shape)}")
                         + f" do not match B={B}, M={M}, C={C}, CO={CO}")
    dev = sample_pts.device
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    if B * M == 0 or N == 0:
        dwcat = zeros(H1 * C * CO) if c_out is not None else zeros(H1, C)
        return zeros(B, N, C), zeros(3, H), zeros(H), *_split_wcat(dwcat, H, C, c_out, w2, b2)
    # the pair kernel writes every row of d_wf, the reduction every value of w1b1
    d_wf = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = _build.stream_of(sample_pts)
    R = B * M
    r2 = radius_sq(radius)
    if G is None:  # the tile kernel writes every row of G and t
        G = torch.empty((B, M, H1, C), dtype=torch.float32, device=dev)
        t = torch.empty((B, M, CO), dtype=torch.float32, device=dev)
        err = lib.mcconv_v1_g_launch(
            _build.ptr(sample_pts), _build.ptr(sample_mask), _build.ptr(source_pts),
            _build.ptr(source_mask), _build.ptr(wf), _build.ptr(w1), _build.ptr(b1),
            _build.ptr(dout), _build.ptr(cnt), B, M, N, C, c_out or 0, H, int(mean_normalize),
            r2, float(radius), _build.ptr(G), _build.ptr(t), stream,
        )
        _build.check(err, "mcconv_v1_tile_kernel (K2v1's G rows)")
    else:
        G = given[0]
        t = (dout * _scale(cnt, sample_mask, mean_normalize)[..., None]).contiguous()

    if c_out is None:  # the pair kernel forms dG = t * [w2; b2] where it reads it
        dG = t
        dwcat = wcat_grad(G, t, R, H1, C, depthwise=True, stream=stream)
    else:
        dG = torch.empty((B, M, H1, C), dtype=torch.float32, device=dev)
        dg_full(t, w2, b2, R, CO, H * C, H1 * C, dG, "mcconv_bwd_dg_full_kernel", stream)
        dwcat = wcat_grad(G, t, R, H1 * C, CO, stream=stream)
    del G  # K2v1's buffer goes back to the allocator before the pair kernel

    blocks = _pair_blocks(B, N, M, C)
    if blocks <= 0:
        raise ValueError(f"{name}: refused shape N={N}, M={M}, C={C}")
    pair_part = torch.empty((blocks, 4, H), dtype=torch.float32, device=dev)
    err = lib.mcconv_bwd_pair_launch(
        _build.ptr(sample_pts), _build.ptr(sample_mask), _build.ptr(source_pts),
        _build.ptr(source_mask), _build.ptr(wf), _build.ptr(w1), _build.ptr(b1),
        _build.ptr(w2), _build.ptr(b2), _build.ptr(dG), B, M, N, C, H, int(c_out is None),
        r2, float(radius), _build.ptr(d_wf), _build.ptr(pair_part), stream,
    )
    _build.check(err, "mcconv_bwd_pair_kernel")
    w1b1 = torch.empty((4, H), dtype=torch.float32, device=dev)
    err = lib.mcconv_bwd_reduce_launch(_build.ptr(pair_part), blocks, 4 * H,
                                       _build.ptr(w1b1), stream)
    _build.check(err, "mcconv_bwd_reduce_kernel (dW1, db1)")
    return d_wf, w1b1[:3], w1b1[3], *_split_wcat(dwcat, H, C, c_out, w2, b2)


def project_full(G, w2, b2, scale, R: int, K: int, KW: int, CO: int, out: torch.Tensor,
                 what: str) -> None:
    """K1's projection GEMM into ``out`` (R, CO): ``scale[r] * sum_k G[r, k]
    [w2; b2][k, o]`` with w2 the first KW of the K rows. The tile and bucket
    convs share it. Where the output tiles would not fill the card the k
    range is split, its partials summed in split order (``_build`` sizes the
    split: ``mcconv_project_splits``)."""
    lib = _build.library()
    splits = lib.mcconv_project_splits(R, K, CO)
    part = out if splits == 1 else torch.empty((splits, R, CO), dtype=torch.float32,
                                               device=out.device)
    err = lib.mcconv_project_full_launch(_build.ptr(G), _build.ptr(w2), _build.ptr(b2),
                                         _build.ptr(scale), R, K, KW, CO, _build.ptr(part),
                                         _build.ptr(out), _build.stream_of(out))
    _build.check(err, what)


def dg_full(t, w2, b2, R: int, CO: int, KW: int, NC: int, dG: torch.Tensor, what: str,
            stream=None) -> None:
    """K2's dG GEMM into ``dG`` (R, NC): ``sum_o t[r, o] Wcat[n, o]`` with
    Wcat's first KW rows from w2 (KW, CO), the rest from b2. The tile and
    bucket backwards share it. Its o range is split as the projection's k
    range (``mcconv_bwd_dg_splits``). ``stream``: dG's current stream, where
    the caller has it already."""
    lib = _build.library()
    splits = lib.mcconv_bwd_dg_splits(R, CO, NC)
    part = dG if splits == 1 else torch.empty((splits, R, NC), dtype=torch.float32,
                                              device=dG.device)
    err = lib.mcconv_bwd_dg_full_launch(_build.ptr(t), _build.ptr(w2), _build.ptr(b2), R, CO,
                                        KW, NC, _build.ptr(part), _build.ptr(dG),
                                        _build.stream_of(dG) if stream is None else stream)
    _build.check(err, what)


def wcat_grad(A: torch.Tensor, t: torch.Tensor, R: int, MA: int, CO: int, *,
              depthwise: bool = False, stream=None) -> torch.Tensor:
    """``[dW2; db2]`` through K2's row-split GEMM over R rows, its chunks'
    partial sums reduced in chunk order: ``A^T t`` as (MA, CO) for A (R, MA)
    and t (R, CO), or with ``depthwise`` ``sum_r A[r, h, c] t[r, c]`` as
    (MA, CO) for A (R, MA, CO). ``stream``: A's current stream, where the
    caller has it already."""
    lib = _build.library()
    stream = _build.stream_of(A) if stream is None else stream
    if depthwise:
        splits, rchunk = _split_rows(R, -(-MA * CO // 256))
        launch, what = lib.mcconv_bwd_dw2_depthwise_launch, "mcconv_bwd_dw2_depthwise_kernel"
    else:
        splits, rchunk = _split_rows(R, -(-MA // 64) * -(-CO // 64))
        launch, what = lib.mcconv_bwd_dw2_full_launch, "mcconv_bwd_dw2_full_kernel"
    out = torch.empty((MA, CO), dtype=torch.float32, device=A.device)
    part = out if splits == 1 else torch.empty((splits, MA, CO), dtype=torch.float32,
                                               device=A.device)
    _build.check(launch(_build.ptr(A), _build.ptr(t), R, MA, CO, splits, rchunk,
                        _build.ptr(part), stream), what)
    if splits > 1:
        err = lib.mcconv_bwd_reduce_launch(_build.ptr(part), splits, MA * CO, _build.ptr(out),
                                           stream)
        _build.check(err, "mcconv_bwd_reduce_kernel (dW2)")
    return out


def ordered_sum(part: torch.Tensor, lib, stream, what: str) -> torch.Tensor:
    """Sum ``part (Z, L)`` over its rows in a fixed order with K2's reduction
    kernel: in one pass, or for many rows in two (rows ``z1 * 256 + z2``
    over z1, then over z2), which keeps every thread's serial sum short.
    ``part`` is zero-padded to a multiple of 256 rows by its allocator
    (``partials``)."""
    Z, L = part.shape
    if Z <= 4 * _REDUCE_SPLIT:
        out = torch.empty((L,), dtype=torch.float32, device=part.device)
        _build.check(lib.mcconv_bwd_reduce_launch(_build.ptr(part), Z, L, _build.ptr(out),
                                                  stream), what)
        return out
    mid = torch.empty((_REDUCE_SPLIT * L,), dtype=torch.float32, device=part.device)
    _build.check(lib.mcconv_bwd_reduce_launch(_build.ptr(part), Z // _REDUCE_SPLIT,
                                              _REDUCE_SPLIT * L, _build.ptr(mid), stream), what)
    out = torch.empty((L,), dtype=torch.float32, device=part.device)
    _build.check(lib.mcconv_bwd_reduce_launch(_build.ptr(mid), _REDUCE_SPLIT, L,
                                              _build.ptr(out), stream), what)
    return out


def partials(Z: int, L: int, dev) -> torch.Tensor:
    """Zeroed (Z', L) partial sums, Z' = Z rounded up to a multiple of 256
    when there are many: a block of an empty cell writes none of its rows."""
    if Z > 4 * _REDUCE_SPLIT:
        Z = -(-Z // _REDUCE_SPLIT) * _REDUCE_SPLIT
    return torch.zeros((Z, L), dtype=torch.float32, device=dev)


def _split_wcat(dwcat, H, C, c_out, w2, b2):
    """(dw2, db2) in the shapes of w2 and b2, from the stacked ``[dW2; db2]``."""
    if c_out is None:
        return dwcat[:H].reshape(w2.shape), dwcat[H].reshape(b2.shape)
    flat = dwcat.reshape(-1)
    return flat[: H * C * c_out].reshape(w2.shape), flat[H * C * c_out :].reshape(b2.shape)


# ------------------------------------------------------------------ K1v1 and K2v1


def _forward_cuda_v1(params, sample_pts, sample_mask, source_pts, source_mask, wf, radius,
                     c_out, mean_normalize):
    """Launch K1v1 (one kernel: in-radius lists, the tile's G in the block, its
    fold into (W2, b2)): ``(out, cnt)``."""
    global launches_v1
    name = "dense_mc_conv (K1v1)"
    w1, b1, w2, b2 = (t.contiguous() for t in params)
    sample_pts, sample_mask = sample_pts.contiguous(), sample_mask.contiguous()
    source_pts, source_mask = source_pts.contiguous(), source_mask.contiguous()
    wf = wf.contiguous()
    B, M, _ = sample_pts.shape
    N, C, H = source_pts.shape[1], wf.shape[-1], w1.shape[1]
    floats = (sample_pts, source_pts, wf, w1, b1, w2, b2)
    _build.require_cuda(name, sample_mask, source_mask, *floats)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name}: positions, features and params must be float32")
    if H != HIDDEN or C > MAX_C:
        raise NotImplementedError(f"{name} is built for H={HIDDEN} and C<={MAX_C}; "
                                  f"got H={H}, C={C}")
    dev = sample_pts.device
    new = torch.zeros if B * M == 0 or N == 0 else torch.empty  # the kernel writes every value
    out = new((B, M, C if c_out is None else c_out), dtype=torch.float32, device=dev)
    cnt = new((B, M), dtype=torch.float32, device=dev)
    if B * M == 0 or N == 0:
        return out, cnt
    err = _build.library().mcconv_v1_fwd_launch(
        _build.ptr(sample_pts), _build.ptr(sample_mask), _build.ptr(source_pts),
        _build.ptr(source_mask), _build.ptr(wf), _build.ptr(w1), _build.ptr(b1),
        _build.ptr(w2), _build.ptr(b2), B, M, N, C, c_out or 0, H, int(mean_normalize),
        radius_sq(radius), float(radius), _build.ptr(out), _build.ptr(cnt),
        _build.stream_of(sample_pts),
    )
    _build.check(err, "mcconv_v1_tile_kernel (K1v1)")
    launches_v1 += 1
    return out, cnt


def dense_mc_conv_v1_backward_reference(
    params: MCConvParams,
    sample_pts: torch.Tensor,
    sample_mask: torch.Tensor,
    source_pts: torch.Tensor,
    source_mask: torch.Tensor,
    wf: torch.Tensor,
    radius: float,
    cnt: torch.Tensor,
    dout: torch.Tensor,
    *,
    c_out: int | None = None,
    mean_normalize: bool = False,
):
    """Plain PyTorch version of K2v1: K2's arguments without G, which it forms
    again from the pairs (as ``_core_bwd`` passes v1 the count only,
    ``dense_conv.py:758-769``). Pre-activations are rounded as ``mc_preact``,
    so the ReLU steps fall as in the kernel. Returns ``(d_wf, dw1, db1, dw2,
    db2)`` in the shapes of ``MCConvParams``."""
    inr, off, pre = _pair_terms(params, sample_pts, sample_mask, source_pts, source_mask,
                                radius, kernel_rounding=True)
    a = torch.cat([torch.relu(pre), torch.ones_like(pre[..., :1])], dim=-1) * inr[..., None]
    G = torch.einsum("bmnh,bnc->bmhc", a, wf)
    t = dout * _scale(cnt, sample_mask, mean_normalize)[..., None]
    return _backward_reference(params, inr, off, pre, wf, G, t, c_out)


def dense_mc_conv_v1_backward_cuda(
    params: MCConvParams,
    sample_pts: torch.Tensor,
    sample_mask: torch.Tensor,
    source_pts: torch.Tensor,
    source_mask: torch.Tensor,
    wf: torch.Tensor,
    radius: float,
    cnt: torch.Tensor,
    dout: torch.Tensor,
    *,
    c_out: int | None = None,
    mean_normalize: bool = False,
):
    """Launch K2v1 on CUDA tensors; the arguments and outputs of its plain version.

    G's rows are formed again from sample-owner in-radius lists by K1v1's
    tile kernel (``csrc/dense_conv_v1_bwd.cu``), then K2's dG GEMM (full
    sites), row-split [dW2; db2] GEMM, pair kernel and reduction run on them
    (``_backward_cuda``): K2's gradients on K1's G, bit for bit. K1's and
    K2's launch counters do not move."""
    global backward_launches_v1
    grads = _backward_cuda("dense_mc_conv_v1_backward_cuda (K2v1)", params, sample_pts,
                           sample_mask, source_pts, source_mask, wf, radius, cnt, dout, c_out,
                           mean_normalize)
    backward_launches_v1 += 1
    return grads


# ------------------------------------------------------------------ autograd


class DenseMCConvFunction(torch.autograd.Function):
    """``(w1, b1, w2, b2, wf) -> (out, cnt)``: K1 (K1p under ``_PLANES_MXU``)
    forward and K2 backward on CUDA tensors, the plain versions on CPU
    tensors. ``cnt`` has no gradient."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, wf, sample_pts, sample_mask, source_pts, source_mask,
                radius, c_out, mean_normalize):
        params = MCConvParams(w1, b1, w2, b2)
        if wf.device.type == "cpu":
            fwd = _forward_planes_reference if _PLANES_MXU else _forward_reference
        else:
            fwd = dense_mc_conv_planes_cuda if _PLANES_MXU else _forward_cuda
        out, cnt, G = fwd(params, sample_pts, sample_mask, source_pts, source_mask, wf,
                          radius, c_out, mean_normalize)
        ctx.save_for_backward(w1, b1, w2, b2, wf, sample_pts, sample_mask, source_pts,
                              source_mask, G, cnt)
        ctx.conv = (radius, c_out, mean_normalize)
        ctx.mark_non_differentiable(cnt)
        return out, cnt

    @staticmethod
    def backward(ctx, dout, _dcnt):
        w1, b1, w2, b2, wf, smp, qmask, src, smask, G, cnt = ctx.saved_tensors
        radius, c_out, mean = ctx.conv
        bwd = (dense_mc_conv_backward_reference if wf.device.type == "cpu"
               else dense_mc_conv_backward_cuda)
        d_wf, dw1, db1, dw2, db2 = bwd(
            MCConvParams(w1, b1, w2, b2), smp, qmask, src, smask, wf, radius, G, cnt,
            dout, c_out=c_out, mean_normalize=mean,
        )
        return dw1, db1, dw2, db2, d_wf, None, None, None, None, None, None, None


class DenseMCConvV1Function(torch.autograd.Function):
    """The v1 route of ``DenseMCConvFunction``: K1v1 forward and K2v1 backward
    on CUDA tensors, the plain versions on CPU tensors. It saves the inputs
    and the count, not G: K2v1 forms the pair planes again."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, wf, sample_pts, sample_mask, source_pts, source_mask,
                radius, c_out, mean_normalize):
        params = MCConvParams(w1, b1, w2, b2)
        args = (params, sample_pts, sample_mask, source_pts, source_mask, wf, radius, c_out,
                mean_normalize)
        if wf.device.type == "cpu":
            out, cnt, _ = _forward_reference(*args)
        else:
            out, cnt = _forward_cuda_v1(*args)
        ctx.save_for_backward(w1, b1, w2, b2, wf, sample_pts, sample_mask, source_pts,
                              source_mask, cnt)
        ctx.conv = (radius, c_out, mean_normalize)
        ctx.mark_non_differentiable(cnt)
        return out, cnt

    @staticmethod
    def backward(ctx, dout, _dcnt):
        w1, b1, w2, b2, wf, smp, qmask, src, smask, cnt = ctx.saved_tensors
        radius, c_out, mean = ctx.conv
        bwd = (dense_mc_conv_v1_backward_reference if wf.device.type == "cpu"
               else dense_mc_conv_v1_backward_cuda)
        d_wf, dw1, db1, dw2, db2 = bwd(
            MCConvParams(w1, b1, w2, b2), smp, qmask, src, smask, wf, radius, cnt, dout,
            c_out=c_out, mean_normalize=mean,
        )
        return dw1, db1, dw2, db2, d_wf, None, None, None, None, None, None, None


def dense_mc_conv(params, sample_pts, sample_mask, source_pts, source_mask,
                  features, pdf, radius, *, c_out=None, mean_normalize=False,
                  with_count=False):
    """The dense MC conv, differentiable: CPU tensor -> plain versions, CUDA
    tensor -> K1 forward and K2 backward (K1v1 and K2v1 under ``_USE_V1``,
    else K1p and K2 under ``_PLANES_MXU``)."""
    wf = _weighted_features(features, pdf, source_mask)
    fn = DenseMCConvV1Function if _USE_V1 else DenseMCConvFunction
    out, cnt = fn.apply(
        *params, wf, sample_pts, sample_mask, source_pts, source_mask, float(radius),
        c_out, mean_normalize,
    )
    return (out, cnt) if with_count else out
