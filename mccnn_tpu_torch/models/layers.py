"""Network building blocks (port of ``mccnn_tpu/models/layers.py``).

Inference only in this slice: ``MaskedBatchNorm`` applies the running
statistics with flax's eval formula and raises in training mode (the masked
batch moments and the running-average update come with the training slice).
Parameter names follow the flax modules (``kernel_w1`` ... on ``MCConv``,
``scale`` / ``bias`` / ``mean`` / ``var`` on the BN) so that ``convert.py``
maps a JAX checkpoint one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from ..api.builder import SpatialCache
from ..core.mcconv import KERNEL_HIDDEN, MCConvParams
from ..ops.cuda.dense_conv import dense_mc_conv
from ..ops.dispatch import pick_backend


def _truncated_normal_(t: torch.Tensor, fan_in: int, gain: float, generator) -> None:
    """flax ``variance_scaling(gain, "fan_in", "truncated_normal")``."""
    std = (gain / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class MCConv(nn.Module):
    """Monte-Carlo spatial convolution between two hierarchy levels.

    ``c_out=None`` -> depthwise; otherwise a full conv to ``c_out`` channels.
    ``use_pdf=False`` is the reference's ``usePDF=False`` (pdf = 1, mean over
    the neighbourhood).
    """

    def __init__(self, c_in: int, c_out: int | None = None, use_pdf: bool = True,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        self.c_in, self.c_out, self.use_pdf = c_in, c_out, use_pdf
        hidden = KERNEL_HIDDEN
        out_dim = c_in if c_out is None else c_in * c_out
        self.kernel_w1 = nn.Parameter(torch.empty(3, hidden))
        self.kernel_b1 = nn.Parameter(torch.zeros(hidden))
        self.kernel_w2 = nn.Parameter(torch.empty(hidden, out_dim))
        self.kernel_b2 = nn.Parameter(torch.zeros(out_dim))
        with torch.no_grad():  # flax he_normal on the (fan_in, fan_out) kernels
            _truncated_normal_(self.kernel_w1, 3, 2.0, generator)
            _truncated_normal_(self.kernel_w2, hidden, 2.0, generator)

    def params(self) -> MCConvParams:
        return MCConvParams(self.kernel_w1, self.kernel_b1, self.kernel_w2, self.kernel_b2)

    def forward(self, cache: SpatialCache, in_level: int, out_level: int, radius: float,
                features: torch.Tensor) -> torch.Tensor:
        src = cache.hierarchy.levels[in_level]
        dst = cache.hierarchy.levels[out_level]
        if self.use_pdf:
            pdf = cache.pdf(in_level, radius)
        else:
            pdf = torch.ones_like(src.mask, dtype=features.dtype)
        pick_backend(
            src.points.shape[1], radius, self.c_in, self.c_out,
            n_samples=dst.points.shape[1], device=features.device,
        )  # "dense" or NotImplementedError
        out = dense_mc_conv(
            self.params(), dst.points, dst.mask, src.points, src.mask, features, pdf,
            radius, c_out=self.c_out, mean_normalize=not self.use_pdf,
        )
        return torch.where(dst.mask[..., None], out, 0.0)


class MaskedBatchNorm(nn.Module):
    """BatchNorm from running statistics: ``(x - mean) / sqrt(var + eps) * scale + bias``.

    Written by hand rather than ``nn.BatchNorm1d``, whose running-variance
    update (unbiased) differs from the reference's. Serves both the
    reference's ``MaskedBatchNorm`` and flax ``nn.BatchNorm`` (same eval
    formula). ``schedule_steps`` adds the reference's ``count`` statistic.
    """

    EPSILON = 1e-5  # the reference's and flax's default

    def __init__(self, num_features: int, schedule_steps: int | None = None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        if schedule_steps:
            self.register_buffer("count", torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm has eval semantics only; training mode comes "
                "with the training slice"
            )
        y = (x - self.mean) / torch.sqrt(self.var + self.EPSILON)
        return y * self.scale + self.bias


class BatchNormReluDropout(nn.Module):
    """BN -> ReLU -> (dropout, a no-op at inference) -> zero the padded points."""

    def __init__(self, num_features: int, schedule_steps: int | None = None):
        super().__init__()
        self.bn = MaskedBatchNorm(num_features, schedule_steps=schedule_steps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn(x))
        return torch.where(mask[..., None], x, 0.0)


class FullyConnected(nn.Module):
    """Dense -> BN -> ReLU head block. The weight is torch's (out, in)
    layout; ``convert.py`` transposes flax's (in, out) kernels."""

    def __init__(self, in_features: int, features: int, schedule_steps: int | None = None,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        self.dense = dense_layer(in_features, features, generator)
        self.bn = MaskedBatchNorm(features, schedule_steps=schedule_steps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.dense(x)))


def dense_layer(in_features: int, features: int, generator=None) -> nn.Linear:
    """``nn.Linear`` with flax ``Dense``'s init (lecun_normal kernel, zero bias)."""
    layer = nn.Linear(in_features, features)
    with torch.no_grad():
        _truncated_normal_(layer.weight, in_features, 1.0, generator)
        layer.bias.zero_()
    return layer
