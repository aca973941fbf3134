"""K1: the dense Monte-Carlo convolution, forward — CUDA wrapper and plain version.

Replaces ``mccnn_tpu/ops/pallas/dense_conv.py::_fwd_kernel_b`` (reached
through ``_fwd_call_b`` and ``dense_mc_conv``), with the same value as the
reference's ``dense_mc_conv`` (``dense_conv.py:803-866``): every valid source
within ``radius`` of a sample contributes, with no neighbour capacity.

The kernels are ``mccnn_tpu_torch/csrc/dense_conv.cu``. Unlike the TPU
kernel, which folds W2 into the features before its one wide MXU product,
they contract over the neighbours first (the bilinear factorisation of
``mccnn_tpu/core/mcconv.py:98-126``): a pair kernel forms
``G[b,i,h,c] = sum_j a_h(i,j) f~[b,j,c]`` and a projection kernel applies
(W2, b2). Stage 1 is bound by pair-plane arithmetic, stage 2 is a small fp32
GEMM (see the source's header). Everything is fp32.

Forward only: the backward kernel (K2) comes with the training slice, so the
CUDA wrapper raises when autograd would have to record it.
"""

from __future__ import annotations

import torch

from ...core.grid import pair_d2, radius_sq
from ...core.mcconv import MCConvParams
from . import _build

MAX_C = 1024  # the pair kernel keeps TS * C <= 1024 outputs of G per block
HIDDEN = 8  # the pair kernel's accumulators are unrolled for H = 8

# Launches of the CUDA kernels since the last reset (see density_kernel.py).
launches = 0


def _weighted_features(features, pdf, source_mask):
    """``features / pdf``, masked to 0 (``dense_conv.py:837-838``)."""
    return torch.where(source_mask[..., None], features / pdf[..., None], 0.0)


def _scale(cnt, sample_mask, mean_normalize):
    """Per-sample output factor: 1/count in mean mode, 0 for masked samples."""
    s = 1.0 / cnt.clamp_min(1.0) if mean_normalize else torch.ones_like(cnt)
    return torch.where(sample_mask, s, 0.0)


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
    """Plain PyTorch version: the same neighbours-first contraction, all pairs.

    Returns ``out (B, M, C | c_out)``, and the in-radius count ``(B, M)`` when
    ``with_count``.
    """
    H = params.w1.shape[1]
    wf = _weighted_features(features, pdf, source_mask)
    inr = (
        (pair_d2(sample_pts, source_pts) <= radius_sq(radius))
        & source_mask[:, None, :]
        & sample_mask[:, :, None]
    )  # (B, M, N)
    off = (source_pts[:, None, :, :] - sample_pts[:, :, None, :]) / radius
    act = torch.relu(off @ params.w1 + params.b1)  # (B, M, N, H)
    a = torch.cat([act, torch.ones_like(act[..., :1])], dim=-1) * inr[..., None]
    G = torch.einsum("bmnh,bnc->bmhc", a, wf)  # (B, M, H+1, C)
    cnt = inr.sum(dim=-1).to(features.dtype)
    if c_out is None:
        out = (G[:, :, :H] * params.w2).sum(dim=2) + G[:, :, H] * params.b2
    else:
        B, M, _, C = G.shape
        out = G[:, :, :H].reshape(B, M, H * C) @ params.w2.reshape(H * C, c_out)
        out = out + G[:, :, H] @ params.b2.reshape(C, c_out)
    out = out * _scale(cnt, sample_mask, mean_normalize)[..., None]
    return (out, cnt) if with_count else out


def dense_mc_conv_cuda(
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
    """Launch K1 (pair kernel + projection kernel) on CUDA tensors."""
    global launches
    tensors = (*params, sample_pts, source_pts, features, pdf)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "dense_mc_conv_cuda is forward only: its backward kernel (K2) comes "
            "with the training slice. Call it under torch.inference_mode()."
        )
    w1, b1, w2, b2 = (t.contiguous() for t in params)
    sample_pts, sample_mask = sample_pts.contiguous(), sample_mask.contiguous()
    source_pts, source_mask = source_pts.contiguous(), source_mask.contiguous()
    wf = _weighted_features(features, pdf, source_mask).contiguous()
    _build.require_cuda(
        "dense_mc_conv_cuda", sample_pts, sample_mask, source_pts, source_mask, wf,
        w1, b1, w2, b2,
    )
    if any(t.dtype != torch.float32 for t in (sample_pts, source_pts, wf, w1, b1, w2, b2)):
        raise TypeError("dense_mc_conv_cuda: positions, features and params must be float32")
    B, M, _ = sample_pts.shape
    N = source_pts.shape[1]
    C = wf.shape[-1]
    H = w1.shape[1]
    if H != HIDDEN or C > MAX_C:
        raise NotImplementedError(
            f"dense_mc_conv_cuda is built for H={HIDDEN} and C<={MAX_C}; got H={H}, C={C}"
        )
    dev = sample_pts.device
    out = torch.zeros((B, M, C if c_out is None else c_out), dtype=torch.float32, device=dev)
    cnt = torch.zeros((B, M), dtype=torch.float32, device=dev)
    if B * M == 0 or N == 0:
        return (out, cnt) if with_count else out
    lib = _build.library()
    stream = _build.stream_of(sample_pts)
    G = torch.empty((B, M, H + 1, C), dtype=torch.float32, device=dev)
    err = lib.mcconv_pair_launch(
        _build.ptr(sample_pts), _build.ptr(sample_mask), _build.ptr(source_pts),
        _build.ptr(source_mask), _build.ptr(wf), _build.ptr(w1), _build.ptr(b1),
        B, M, N, C, H, radius_sq(radius), float(radius), _build.ptr(G),
        _build.ptr(cnt), stream,
    )
    _build.check(err, "mcconv_pair_kernel")
    scale = _scale(cnt, sample_mask, mean_normalize).contiguous()
    if c_out is None:
        err = lib.mcconv_project_depthwise_launch(
            _build.ptr(G), _build.ptr(w2), _build.ptr(b2), _build.ptr(scale),
            B * M, H, C, _build.ptr(out), stream,
        )
    else:
        err = lib.mcconv_project_full_launch(
            _build.ptr(G), _build.ptr(w2), _build.ptr(b2), _build.ptr(scale),
            B * M, (H + 1) * C, H * C, c_out, _build.ptr(out), stream,
        )
    _build.check(err, "mcconv_project_kernel")
    launches += 1
    return (out, cnt) if with_count else out


def dense_mc_conv(params, sample_pts, sample_mask, source_pts, source_mask,
                  features, pdf, radius, *, c_out=None, mean_normalize=False,
                  with_count=False):
    """CPU tensor -> plain version; CUDA tensor -> K1."""
    fn = dense_mc_conv_reference if sample_pts.device.type == "cpu" else dense_mc_conv_cuda
    return fn(
        params, sample_pts, sample_mask, source_pts, source_mask, features, pdf,
        radius, c_out=c_out, mean_normalize=mean_normalize, with_count=with_count,
    )
