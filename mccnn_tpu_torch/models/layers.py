"""Network building blocks (port of ``mccnn_tpu/models/layers.py``).

Train and eval follow ``nn.Module.train()`` / ``eval()`` where the flax
modules take ``train``. Parameter names follow the flax modules
(``kernel_w1`` ... on ``MCConv``, ``scale`` / ``bias`` / ``mean`` / ``var`` on
the BN) so that ``convert.py`` maps a JAX checkpoint one to one.

Dropout draws from an explicit ``torch.Generator`` that the trainer sets with
``set_dropout_generator``; there is no global RNG, and a module in training
mode with a nonzero rate and no generator raises. The draws differ from
``jax.random``'s for the same seed (ROADMAP queue 3).
"""

from __future__ import annotations

import torch
from torch import nn

from ..api.builder import SpatialCache
from ..core.mcconv import KERNEL_HIDDEN, MCConvParams
from ..ops.cuda.dense_conv import dense_mc_conv
from ..ops.cuda.mcconv_kernel import bucket_mc_conv
from ..ops.cuda.tile_conv import tile_mc_conv
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
        """Route by shape (``ops/dispatch.py``), as ``layers.py:70-131``:
        ``dense``, ``bucket``, or ``tile`` (a ``bucket`` site when the cache
        holds a tile capacity). A tile site reports its dropped steps to the
        cache; a bucket site reports nothing, as in the reference (its grid
        overflow drops points silently, ``BucketGrid.overflow`` counts them)."""
        src = cache.hierarchy.levels[in_level]
        dst = cache.hierarchy.levels[out_level]
        backend = pick_backend(
            src.points.shape[1], radius, self.c_in, self.c_out,
            n_samples=dst.points.shape[1], mode=cache.conv_backend,
        )
        if backend == "bucket" and cache.tile_pairs is not None:
            backend = "tile"  # z-order tiles beat buckets at big-scene scale
        if backend == "jnp":
            raise NotImplementedError(
                f"conv site N={src.points.shape[1]}, r={radius}: the K-capacity conv "
                "(mccnn_tpu/core/mcconv.py:87) is not ported (ROADMAP queue 1 item 4)"
            )
        if backend == "tile" and cache.tile_pairs is None:
            raise ValueError("the tile backend needs SpatialCache(tile_pairs=...): size it "
                             "with ops.cuda.tile_conv.auto_tile_pairs on representative data")
        if self.use_pdf:
            pdf = cache.pdf(in_level, radius)
        else:
            pdf = torch.ones_like(src.mask, dtype=features.dtype)
        args = (self.params(), dst.points, dst.mask, src.points, src.mask, features, pdf,
                radius)
        if backend == "tile":
            # the capacity is sized for the level-0 sites; deeper sites run lossless
            max_pairs = cache.tile_pairs if 0 in (in_level, out_level) else 1 << 30
            out, overflow = tile_mc_conv(
                *args, max_pairs=max_pairs,
                max_steps=cache.site_steps("conv", in_level, out_level, radius),
                c_out=self.c_out, mean_normalize=not self.use_pdf, with_overflow=True,
            )
            cache.report_tile_overflow(overflow)
        elif backend == "bucket":
            out = bucket_mc_conv(self.params(), cache.buckets(out_level, radius), dst.mask,
                                 cache.buckets(in_level, radius), features, pdf,
                                 c_out=self.c_out, mean_normalize=not self.use_pdf)
        else:
            out = dense_mc_conv(*args, c_out=self.c_out, mean_normalize=not self.use_pdf)
        return torch.where(dst.mask[..., None], out, 0.0)


class Conv1x1(nn.Linear):
    """Per-point feature mixing (``mccnn_tpu/models/layers.py:134``): flax
    ``Dense`` over the last axis, with its init (lecun_normal, zero bias)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 *, generator: torch.Generator | None = None):
        super().__init__(in_features, features, bias=use_bias)
        with torch.no_grad():
            _truncated_normal_(self.weight, in_features, 1.0, generator)
            if use_bias:
                self.bias.zero_()


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the (batch, point) axes that ignores padded points
    (``mccnn_tpu/models/layers.py:171-229``).

    Training mode normalises with the masked batch mean and the biased masked
    variance (two-pass) and updates the running statistics as
    ``m * running + (1 - m) * batch``, with flax's ``momentum`` convention
    (0.9 keeps 90% of the old value; torch's ``BatchNorm1d`` would call that
    0.1 and update with the unbiased variance). ``schedule_steps`` turns on
    the reference's decaying momentum ``min(0.99, 1 - 0.5 * 0.5^(count /
    schedule_steps))`` with its ``count`` buffer. Eval mode applies the running
    statistics, as flax's eval formula.
    """

    EPSILON = 1e-5  # the reference's and flax's default

    def __init__(self, num_features: int, momentum: float = 0.9,
                 schedule_steps: int | None = None):
        super().__init__()
        self.momentum, self.schedule_steps = momentum, schedule_steps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        if schedule_steps:
            self.register_buffer("count", torch.zeros(()))

    def batch_moments(self, xf: torch.Tensor, m: torch.Tensor):
        """Masked mean and biased two-pass variance of ``xf (rows, C)``."""
        n = m.sum().clamp_min(1.0)
        mean = (xf * m).sum(0) / n
        var = ((xf - mean) ** 2 * m).sum(0) / n
        return mean, var

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.training:
            c = x.shape[-1]
            xf = x.reshape(-1, c)
            if mask is None:
                m = torch.ones_like(xf[:, :1])
            else:
                m = mask.reshape(-1, 1).to(x.dtype)
            mean, var = self.batch_moments(xf, m)
            with torch.no_grad():
                if self.schedule_steps:
                    mom = torch.clamp(
                        1.0 - 0.5 * 0.5 ** (self.count / self.schedule_steps), max=0.99
                    )
                    self.count.add_(1.0)
                else:
                    mom = self.momentum
                self.mean.copy_(mom * self.mean + (1 - mom) * mean)
                self.var.copy_(mom * self.var + (1 - mom) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) / torch.sqrt(var + self.EPSILON)
        return y * self.scale + self.bias


class HeadBatchNorm(MaskedBatchNorm):
    """flax ``nn.BatchNorm`` over unpadded rows: the head's BN when no momentum
    schedule is set (``mccnn_tpu/models/layers.py:253-256``).

    flax 0.12 computes the batch variance in one pass, ``mean(x^2) -
    mean(x)^2`` clamped at 0 (``use_fast_variance``), where the conv BN's
    ``MaskedBatchNorm`` takes the two-pass ``mean((x - mean)^2)``; the two
    round differently, so each BN keeps its reference's formula.
    """

    def batch_moments(self, xf: torch.Tensor, m: torch.Tensor):
        mean = xf.mean(0)
        var = (xf.square().mean(0) - mean.square()).clamp_min(0.0)
        return mean, var


class Dropout(nn.Module):
    """``flax.linen.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``; the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError(
                "Dropout in training mode needs a generator: call "
                "models.layers.set_dropout_generator(model, generator)"
            )
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Point every ``Dropout`` of ``model`` at ``generator`` (on the model's
    device); the trainer owns and checkpoints it."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class BatchNormReluDropout(nn.Module):
    """BN -> ReLU -> dropout -> zero the padded points."""

    def __init__(self, num_features: int, drop_rate: float = 0.0, momentum: float = 0.9,
                 schedule_steps: int | None = None):
        super().__init__()
        self.bn = MaskedBatchNorm(num_features, momentum=momentum,
                                  schedule_steps=schedule_steps)
        self.dropout = Dropout(drop_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.dropout(torch.relu(self.bn(x, mask)))
        return torch.where(mask[..., None], x, 0.0)


class FullyConnected(nn.Module):
    """Dense -> BN -> ReLU -> dropout head block. The weight is torch's
    (out, in) layout; ``convert.py`` transposes flax's (in, out) kernels. The
    BN is ``HeadBatchNorm`` (flax ``nn.BatchNorm``) without a momentum
    schedule and ``MaskedBatchNorm`` with one, as in the reference."""

    def __init__(self, in_features: int, features: int, drop_rate: float = 0.0,
                 momentum: float = 0.9, schedule_steps: int | None = None,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        self.dense = dense_layer(in_features, features, generator)
        if schedule_steps:
            self.bn = MaskedBatchNorm(features, schedule_steps=schedule_steps)
        else:
            self.bn = HeadBatchNorm(features, momentum=momentum)
        self.dropout = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(torch.relu(self.bn(self.dense(x))))


def dense_layer(in_features: int, features: int, generator=None) -> nn.Linear:
    """``nn.Linear`` with flax ``Dense``'s init (lecun_normal kernel, zero bias)."""
    return Conv1x1(in_features, features, generator=generator)
