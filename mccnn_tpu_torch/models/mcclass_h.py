"""MCClassH — the hierarchical two-path classifier for non-uniform sampling
(port of ``mccnn_tpu/models/mcclass_h.py``).

Path A runs a trunk of full MC convs (grow, 2 grow, 8 grow wide) down a
hierarchy of the whole cloud (radii 0.1 / 0.4 + global). Path B builds its
own hierarchy (the thinning radius 0.1, then 0.2 / 0.4 + global), gathers
the input features onto its Poisson-thinned level 1 and runs a trunk from
there. Three heads (FC 4 grow, FC grow, logits) classify path A's
descriptor, path B's and their concatenation; ``forward`` returns ``(joint,
a, b)``, which ``train.classh_loss`` combines. Path B's hierarchy is built
apart from path A's, as the reference builds it, though their first two
levels agree.

Module names follow the flax module's: ``path_a`` / ``path_b`` (each with
``convs`` named ``conv_{i}_{o}`` and ``bn_relus`` in call order) and the heads
``{a,b,joint}_{fc1,fc2,logits}`` in ``heads``, so ``convert.py`` maps a JAX
checkpoint one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from ..api.builder import SpatialCache
from ..api.hierarchy import GLOBAL_RADIUS, PointHierarchy, build_hierarchy
from ..core.gather import gather_rows
from .layers import BatchNormReluDropout, FullyConnected, MCConv, dense_layer


class _Trunk(nn.Module):
    """Full MC convs down a hierarchy from ``start_level`` to the global
    descriptor, each followed by BN + ReLU (``mcclass_h.py:26-61``)."""

    def __init__(self, radii: tuple[float, ...], widths: tuple[int, ...], c_in: int,
                 conv_radius_scale: float, use_pdf: bool, bn_momentum: float,
                 bn_schedule_steps: int | None, start_level: int, generator):
        super().__init__()
        self.radii, self.conv_radius_scale = tuple(radii), conv_radius_scale
        self.start_level = start_level
        self.convs = nn.ModuleDict()
        self.bn_relus = nn.ModuleList()
        for i, w in enumerate(widths):
            in_level = start_level + i
            self.convs[f"conv_{in_level}_{in_level + 1}"] = MCConv(
                c_in, w, use_pdf=use_pdf, generator=generator)
            self.bn_relus.append(BatchNormReluDropout(w, momentum=bn_momentum,
                                                      schedule_steps=bn_schedule_steps))
            c_in = w

    def forward(self, hier: PointHierarchy, features: torch.Tensor) -> torch.Tensor:
        cache = SpatialCache(hier)
        x = features
        for i, (conv, bn_relu) in enumerate(zip(self.convs.values(), self.bn_relus)):
            in_level = self.start_level + i
            out_level = in_level + 1
            radius = (GLOBAL_RADIUS if out_level == len(hier) - 1
                      else self.radii[i] * self.conv_radius_scale)
            x = conv(cache, in_level, out_level, radius, x)
            x = bn_relu(x, hier.levels[out_level].mask)
        return x[:, 0]


class MCClassH(nn.Module):
    """Constructor fields and defaults follow the flax module, plus
    ``in_features`` (the input width flax infers at init; default 1, the
    all-ones features) and ``generator`` (the seeded initialiser)."""

    def __init__(
        self,
        n_classes: int = 40,
        grow: int = 128,
        radii_a: tuple[float, ...] = (0.1, 0.4),
        radii_b: tuple[float, ...] = (0.2, 0.4),
        subsample_radius_b: float = 0.1,
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
        self.n_classes, self.grow = n_classes, grow
        self.radii_a, self.radii_b = tuple(radii_a), tuple(radii_b)
        self.subsample_radius_b, self.neighbor_k = subsample_radius_b, neighbor_k
        self.drop_rate, self.bn_momentum, self.use_pdf = drop_rate, bn_momentum, use_pdf
        g = grow
        widths = (g, 2 * g, 8 * g)
        trunk_kw = dict(c_in=in_features, conv_radius_scale=conv_radius_scale,
                        use_pdf=use_pdf, bn_momentum=bn_momentum,
                        bn_schedule_steps=bn_schedule_steps, generator=generator)
        self.path_a = _Trunk(self.radii_a, widths, start_level=0, **trunk_kw)
        self.path_b = _Trunk(self.radii_b, widths, start_level=1, **trunk_kw)
        fc_kw = dict(drop_rate=drop_rate, momentum=bn_momentum,
                     schedule_steps=bn_schedule_steps, generator=generator)
        self.heads = nn.ModuleDict()
        for name, c in (("a", 8 * g), ("b", 8 * g), ("joint", 16 * g)):
            self.heads[f"{name}_fc1"] = FullyConnected(c, 4 * g, **fc_kw)
            self.heads[f"{name}_fc2"] = FullyConnected(4 * g, g, **fc_kw)
            self.heads[f"{name}_logits"] = dense_layer(g, n_classes, generator)

    def _head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for part in ("fc1", "fc2", "logits"):
            x = self.heads[f"{name}_{part}"](x)
        return x

    def forward(
        self,
        points: torch.Tensor,  # (B, N, 3), normalized to the unit cube
        mask: torch.Tensor,  # (B, N) bool
        features: torch.Tensor | None = None,  # (B, N, C); default all-ones
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if features is None:
            features = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                                  device=points.device)
        hier_a = build_hierarchy(points, mask, self.radii_a, neighbor_k=self.neighbor_k,
                                 global_level=True)
        desc_a = self.path_a(hier_a, features)
        hier_b = build_hierarchy(points, mask, (self.subsample_radius_b,) + self.radii_b,
                                 neighbor_k=self.neighbor_k, global_level=True)
        ss = hier_b.levels[1].sample
        feats_b = torch.where(ss.mask[..., None], gather_rows(features, ss.idx), 0.0)
        desc_b = self.path_b(hier_b, feats_b)
        logits_a, logits_b = self._head("a", desc_a), self._head("b", desc_b)
        return self._head("joint", torch.cat([desc_a, desc_b], dim=-1)), logits_a, logits_b
