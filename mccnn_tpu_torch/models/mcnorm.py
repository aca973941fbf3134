"""MCNorm / MCNormS — per-point normal estimation (port of ``mccnn_tpu/models/mcnorm.py``).

An encoder-decoder over a Poisson hierarchy of ``len(radii) + 1`` levels (no
global level): full MC convs down the hierarchy (widths ``grow * 2^i``), each
followed by BN + ReLU and kept as a skip; then depthwise MC convs back up,
each followed by BN + ReLU, the skip of the level it lands on (below level
0), a 1x1 mix to ``max(C // 2, grow)`` and BN + ReLU; a dense layer gives a
3-vector per point, zero on padded points. MCNormS is MCNorm with one radius
(0.15), held under the flax name ``trunk``.

Submodules carry the flax module's names (``enc_0_1``, ``dec_1_0``,
``dec_mix_0``, ``normals``); the six ``BatchNormReluDropout`` of the default
MCNorm sit in ``bn_relus`` in the order the flax module creates them, which
numbers them (``BatchNormReluDropout_k``), so ``convert.py`` maps them by
index.
"""

from __future__ import annotations

import torch
from torch import nn

from ..api.builder import SpatialCache
from ..api.hierarchy import build_hierarchy
from .layers import BatchNormReluDropout, Conv1x1, MCConv, dense_layer


class MCNorm(nn.Module):
    """Constructor fields and defaults follow the flax module. Added:
    ``in_features`` (flax infers it at init; default 1, the all-ones
    features) and ``generator`` (the seeded initialiser). ``neighbor_k`` is
    the capacity of the sampler's self-neighbour lists, which a cloud of more
    than 4096 points takes (``build_hierarchy``)."""

    def __init__(
        self,
        grow: int = 64,
        radii: tuple[float, ...] = (0.1, 0.4),
        conv_radius_scale: float = 2.0,
        neighbor_k: int = 32,
        use_pdf: bool = True,
        bn_momentum: float = 0.9,
        bn_schedule_steps: int | None = None,
        in_features: int = 1,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.grow, self.radii = grow, tuple(radii)
        self.conv_radius_scale, self.neighbor_k = conv_radius_scale, neighbor_k
        self.use_pdf = use_pdf
        g = grow
        n_levels = len(self.radii) + 1
        widths = [g * (2**i) for i in range(n_levels - 1)]

        def bn_relu(c):
            return BatchNormReluDropout(c, momentum=bn_momentum, schedule_steps=bn_schedule_steps)

        convs, mixes, bns = {}, {}, []
        c = in_features
        for lvl in range(n_levels - 1):
            convs[f"enc_{lvl}_{lvl + 1}"] = MCConv(c, widths[lvl], use_pdf=use_pdf,
                                                   generator=generator)
            c = widths[lvl]
            bns.append(bn_relu(c))
        for lvl in range(n_levels - 2, -1, -1):
            convs[f"dec_{lvl + 1}_{lvl}"] = MCConv(c, None, use_pdf=use_pdf, generator=generator)
            bns.append(bn_relu(c))
            cat = c + (widths[lvl - 1] if lvl > 0 else 0)
            c = max(cat // 2, g)
            mixes[f"dec_mix_{lvl}"] = Conv1x1(cat, c, generator=generator)
            bns.append(bn_relu(c))
        self.convs = nn.ModuleDict(convs)
        self.mixes = nn.ModuleDict(mixes)
        self.bn_relus = nn.ModuleList(bns)
        self.normals = dense_layer(c, 3, generator)

    def forward(
        self,
        points: torch.Tensor,  # (B, N, 3), normalized to the unit cube
        mask: torch.Tensor,  # (B, N) bool
        features: torch.Tensor | None = None,  # (B, N, C); default all-ones
    ) -> torch.Tensor:
        if features is None:
            features = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                                  device=points.device)
        hier = build_hierarchy(points, mask, self.radii, neighbor_k=self.neighbor_k,
                               global_level=False)
        cache = SpatialCache(hier)
        n_levels = len(hier)
        bns = iter(self.bn_relus)

        x = features
        skips = []
        for lvl in range(n_levels - 1):
            radius = self.radii[lvl] * self.conv_radius_scale
            x = self.convs[f"enc_{lvl}_{lvl + 1}"](cache, lvl, lvl + 1, radius, x)
            x = next(bns)(x, hier.levels[lvl + 1].mask)
            skips.append(x)
        for lvl in range(n_levels - 2, -1, -1):
            radius = self.radii[lvl] * self.conv_radius_scale
            out_mask = hier.levels[lvl].mask
            x = self.convs[f"dec_{lvl + 1}_{lvl}"](cache, lvl + 1, lvl, radius, x)
            x = next(bns)(x, out_mask)
            if lvl > 0:
                x = torch.cat([x, skips[lvl - 1]], dim=-1)
            x = self.mixes[f"dec_mix_{lvl}"](x)
            x = next(bns)(x, out_mask)
        return torch.where(mask[..., None], self.normals(x), 0.0)


class MCNormS(nn.Module):
    """The single-level variant: MCNorm with one radius, as the flax module's
    submodule ``trunk``."""

    def __init__(
        self,
        grow: int = 64,
        radius: float = 0.15,
        conv_radius_scale: float = 2.0,
        neighbor_k: int = 32,
        use_pdf: bool = True,
        bn_momentum: float = 0.9,
        bn_schedule_steps: int | None = None,
        in_features: int = 1,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.trunk = MCNorm(grow=grow, radii=(radius,), conv_radius_scale=conv_radius_scale,
                            neighbor_k=neighbor_k, use_pdf=use_pdf, bn_momentum=bn_momentum,
                            bn_schedule_steps=bn_schedule_steps, in_features=in_features,
                            generator=generator)

    def forward(self, points, mask, features=None) -> torch.Tensor:
        return self.trunk(points, mask, features)
