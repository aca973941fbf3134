"""MCClass — the deeper single-path ModelNet40 classifier
(port of ``mccnn_tpu/models/mcclass.py``).

A full stem conv into ``grow`` channels at level 0, then per level a
down-sampling depthwise conv, BN + ReLU with per-point dropout
(``point_drop_rate``, training only), a ``Conv1x1`` mix to the level's width
(2, 4, 8, 16 x ``grow``) and BN + ReLU, and, below the global level, a
same-level depthwise conv whose BN + ReLU output is mixed back in as a
residual (``same_mix``). Two ``FullyConnected`` layers and the logits close
it. With the defaults (grow 64, radii 0.1 / 0.2 / 0.4) the hierarchy has five
levels, the convs run at r = 0.2 / 0.4 / 0.8 and global, and the widths reach
512 depthwise before the 1024-wide mix.

Module names follow the flax module's (``stem``, ``down_{l}_{o}``,
``same_{o}`` in ``convs``; ``mix_{o}``, ``same_mix_{o}`` in ``mixes``), and
``bn_relus`` holds the BN blocks in call order, as flax numbers its
``BatchNormReluDropout_k``, so ``convert.py`` maps a JAX checkpoint one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from ..api.builder import SpatialCache
from ..api.hierarchy import GLOBAL_RADIUS, build_hierarchy
from .layers import BatchNormReluDropout, Conv1x1, FullyConnected, MCConv, dense_layer


class MCClass(nn.Module):
    """Constructor fields and defaults follow the flax module, plus
    ``in_features`` (the input width flax infers at init; default 1, the
    all-ones features) and ``generator`` (the seeded initialiser)."""

    def __init__(
        self,
        n_classes: int = 40,
        grow: int = 64,
        radii: tuple[float, ...] = (0.1, 0.2, 0.4),
        conv_radius_scale: float = 2.0,
        neighbor_k: int = 32,
        drop_rate: float = 0.5,
        point_drop_rate: float = 0.2,
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
        self.n_classes, self.grow, self.radii = n_classes, grow, tuple(radii)
        self.conv_radius_scale, self.neighbor_k = conv_radius_scale, neighbor_k
        self.drop_rate, self.point_drop_rate = drop_rate, point_drop_rate
        self.use_pdf, self.bn_momentum = use_pdf, bn_momentum
        g = grow
        bn_kw = dict(momentum=bn_momentum, schedule_steps=bn_schedule_steps)
        self.convs = nn.ModuleDict()
        self.mixes = nn.ModuleDict()
        self.bn_relus = nn.ModuleList()
        self.convs["stem"] = MCConv(in_features, g, use_pdf=use_pdf, generator=generator)
        self.bn_relus.append(BatchNormReluDropout(g, **bn_kw))
        widths = [2 * g, 4 * g, 8 * g, 16 * g]  # per level after down-sampling
        n_levels = len(self.radii) + 2  # level 0, one per radius, the global level
        c = g
        for lvl in range(n_levels - 1):
            out = lvl + 1
            self.convs[f"down_{lvl}_{out}"] = MCConv(c, None, use_pdf=use_pdf,
                                                     generator=generator)
            self.bn_relus.append(BatchNormReluDropout(c, drop_rate=point_drop_rate, **bn_kw))
            w = widths[min(lvl, len(widths) - 1)]
            self.mixes[f"mix_{out}"] = Conv1x1(c, w, generator=generator)
            self.bn_relus.append(BatchNormReluDropout(w, **bn_kw))
            c = w
            if out < n_levels - 1:
                self.convs[f"same_{out}"] = MCConv(c, None, use_pdf=use_pdf,
                                                   generator=generator)
                self.bn_relus.append(BatchNormReluDropout(c, **bn_kw))
                self.mixes[f"same_mix_{out}"] = Conv1x1(c, c, generator=generator)
        fc_kw = dict(drop_rate=drop_rate, momentum=bn_momentum,
                     schedule_steps=bn_schedule_steps, generator=generator)
        self.fcs = nn.ModuleList(
            [FullyConnected(c, 8 * g, **fc_kw), FullyConnected(8 * g, 2 * g, **fc_kw)]
        )
        self.logits = dense_layer(2 * g, n_classes, generator)

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
                               global_level=True)
        cache = SpatialCache(hier)
        bns = iter(self.bn_relus)
        x = self.convs["stem"](cache, 0, 0, self.radii[0], features)
        x = next(bns)(x, hier.levels[0].mask)
        n_levels = len(hier)
        for lvl in range(n_levels - 1):
            out = lvl + 1
            radius = (GLOBAL_RADIUS if out == n_levels - 1
                      else self.radii[lvl] * self.conv_radius_scale)
            out_mask = hier.levels[out].mask
            x = self.convs[f"down_{lvl}_{out}"](cache, lvl, out, radius, x)
            x = next(bns)(x, out_mask)
            x = next(bns)(self.mixes[f"mix_{out}"](x), out_mask)
            if out < n_levels - 1:
                y = self.convs[f"same_{out}"](cache, out, out, radius, x)
                y = next(bns)(y, out_mask)
                x = x + self.mixes[f"same_mix_{out}"](y)
        x = x[:, 0]  # (B, 16g) — the global level has one point per cloud
        for fc in self.fcs:
            x = fc(x)
        return self.logits(x)

