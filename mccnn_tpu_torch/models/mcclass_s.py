"""MCClassS — the small single-path ModelNet40 classifier
(port of ``mccnn_tpu/models/mcclass_s.py``).

A three-level Poisson hierarchy (radii 0.1 / 0.4 / global), a chain of full
MC convs (width grow -> 2 grow -> 8 grow) each followed by BN + ReLU, then an
FC head with dropout to the class logits. ``model.train()`` /
``model.eval()`` take the place of the flax module's ``train`` argument; in
training the BNs use batch moments and update their running statistics, and
the head's dropout draws from the generator set by
``layers.set_dropout_generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..api.builder import SpatialCache
from ..api.hierarchy import GLOBAL_RADIUS, build_hierarchy
from .layers import BatchNormReluDropout, FullyConnected, MCConv, dense_layer


class MCClassS(nn.Module):
    """Constructor fields and defaults follow the flax module. Two differ in
    kind: ``in_features`` (flax infers the input width at init; default 1,
    the all-ones features) and ``generator`` (the seeded initialiser).
    ``neighbor_k`` is the capacity of the sampler's self-neighbour lists,
    which a cloud of more than 4096 points takes (``build_hierarchy``).
    ``drop_rate`` is the
    head's dropout, ``bn_momentum`` the BNs' running-average momentum, and
    ``bn_schedule_steps`` the decaying-momentum schedule (with the BN
    ``count`` statistic a checkpoint holds)."""

    def __init__(
        self,
        n_classes: int = 40,
        grow: int = 128,
        radii: tuple[float, ...] = (0.1, 0.4),
        conv_radius_scale: float = 2.0,
        neighbor_k: int = 32,
        drop_rate: float = 0.5,
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
        self.drop_rate, self.bn_momentum, self.use_pdf = drop_rate, bn_momentum, use_pdf
        g = grow
        widths = [g, 2 * g, 8 * g]
        c_ins = [in_features, *widths[:-1]]
        self.convs = nn.ModuleDict()
        self.bn_relus = nn.ModuleList()
        for lvl, (c_in, w) in enumerate(zip(c_ins, widths)):
            self.convs[f"conv_{lvl}_{lvl + 1}"] = MCConv(
                c_in, w, use_pdf=use_pdf, generator=generator
            )
            self.bn_relus.append(
                BatchNormReluDropout(w, momentum=bn_momentum, schedule_steps=bn_schedule_steps)
            )
        fc_kw = dict(drop_rate=drop_rate, momentum=bn_momentum,
                     schedule_steps=bn_schedule_steps, generator=generator)
        self.fcs = nn.ModuleList(
            [FullyConnected(8 * g, 4 * g, **fc_kw), FullyConnected(4 * g, g, **fc_kw)]
        )
        self.logits = dense_layer(g, n_classes, generator)

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
        x = features
        for lvl, (conv, bn_relu) in enumerate(zip(self.convs.values(), self.bn_relus)):
            out_level = lvl + 1
            radius = (
                GLOBAL_RADIUS
                if out_level == len(hier) - 1
                else self.radii[lvl] * self.conv_radius_scale
            )
            x = conv(cache, lvl, out_level, radius, x)
            x = bn_relu(x, hier.levels[out_level].mask)
        x = x[:, 0]  # (B, 8g) — the global level has one point per cloud
        for fc in self.fcs:
            x = fc(x)
        return self.logits(x)
