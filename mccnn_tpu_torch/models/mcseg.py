"""MCSeg — the U-Net-style encoder-decoder for point-cloud segmentation
(port of ``mccnn_tpu/models/mcseg.py``).

A Poisson hierarchy of ``len(radii) + 1`` levels; a full MC-conv stem at
level 0, then per level a depthwise down-sampling conv, BN + ReLU, a 1x1
mixing layer to twice the level's width and BN + ReLU; the decoder runs the
same convs coarse to fine, concatenates the encoder's skip features, mixes
and normalises (dropout on the last level), and a dense layer gives the
per-point logits. An optional per-cloud category one-hot (ShapeNet) is
broadcast to every point and joins the input features.

Submodules carry the flax module's names (``stem``, ``enc_0_1``,
``enc_bn_1``, ``enc_mix_1``, ``dec_1_0``, ``logits``, ...) so that
``convert.py`` maps a JAX MCSeg's variables one to one.

With ``tile_pairs`` set, the big levels take the z-order tile kernels (the
sampler's K8, the KDE's K7, the conv's K5). Without it, a level of more than
``DENSE_SAMPLER_MAX_N`` points is sampled through its ``neighbor_k``
self-neighbours and the big conv sites take the cell-bucket conv (K9), the
reference's capacity-free fallback for direct model users. The tile kernels'
dropped-step counts, which
the flax module sows into ``diagnostics``, come back as one value per forward
pass: ``forward(..., with_overflow=True)`` returns ``(logits, overflow)``,
the largest count of any site of any cloud. Without it a nonzero count
raises, so a short capacity never passes silently.
"""

from __future__ import annotations

import torch
from torch import nn

from ..api.builder import SpatialCache
from ..api.hierarchy import PointHierarchy, build_hierarchy
from .layers import BatchNormReluDropout, Conv1x1, MCConv


class MCSeg(nn.Module):
    """Constructor fields and defaults follow the flax module. Added:
    ``in_features`` and ``n_categories`` (flax infers the stem's input width at
    init), ``conv_backend`` (``SpatialCache.conv_backend``: "auto" routes by
    shape) and ``generator`` (the seeded initialiser). ``neighbor_k`` is the
    capacity of the level-0 sampler's self-neighbour lists when there is no
    tile capacity (``build_hierarchy``)."""

    def __init__(
        self,
        n_classes: int = 50,
        grow: int = 64,
        radii: tuple[float, ...] = (0.025, 0.1, 0.4),
        conv_radius_scale: float = 2.0,
        neighbor_k: int = 32,
        drop_rate: float = 0.2,
        use_pdf: bool = True,
        bn_momentum: float = 0.9,
        bn_schedule_steps: int | None = None,
        tile_pairs: int | None = None,
        tile_steps: dict | None = None,
        in_features: int = 1,
        n_categories: int = 0,
        conv_backend: str = "auto",
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_classes, self.grow, self.radii = n_classes, grow, tuple(radii)
        self.conv_radius_scale, self.neighbor_k = conv_radius_scale, neighbor_k
        self.drop_rate, self.use_pdf = drop_rate, use_pdf
        self.tile_pairs, self.tile_steps = tile_pairs, tile_steps
        self.conv_backend = conv_backend
        g = grow
        n_levels = len(self.radii) + 1
        widths = [g * (2**i) for i in range(n_levels - 1)]
        convs, bns, mixes = {}, {}, {}

        def bn(name, c, drop_rate=0.0):
            bns[name] = BatchNormReluDropout(c, drop_rate=drop_rate, momentum=bn_momentum,
                                             schedule_steps=bn_schedule_steps)

        convs["stem"] = MCConv(in_features + n_categories, g, use_pdf=use_pdf,
                               generator=generator)
        bn("stem_bn", g)
        c, skips = g, [g]
        for lvl in range(n_levels - 1):
            convs[f"enc_{lvl}_{lvl + 1}"] = MCConv(c, None, use_pdf=use_pdf, generator=generator)
            bn(f"enc_bn_{lvl + 1}", c)
            mixes[f"enc_mix_{lvl + 1}"] = Conv1x1(c, widths[lvl] * 2, generator=generator)
            c = widths[lvl] * 2
            bn(f"enc_mix_bn_{lvl + 1}", c)
            if lvl + 1 < n_levels - 1:
                skips.append(c)
        for lvl in range(n_levels - 2, -1, -1):
            convs[f"dec_{lvl + 1}_{lvl}"] = MCConv(c, None, use_pdf=use_pdf, generator=generator)
            bn(f"dec_bn_{lvl}", c)
            cat = c + skips[lvl]
            c = max(cat // 2, g)
            mixes[f"dec_mix_{lvl}"] = Conv1x1(cat, c, generator=generator)
            bn(f"dec_mix_bn_{lvl}", c, drop_rate if lvl == 0 else 0.0)
        self.convs = nn.ModuleDict(convs)
        self.bns = nn.ModuleDict(bns)
        self.mixes = nn.ModuleDict(mixes)
        self.logits = Conv1x1(c, n_classes, generator=generator)

    def tile_sites(self, n_levels: int) -> list[tuple]:
        """Every tile-kernel site of the network as ``tile_steps`` keys
        (``mcseg.py:44-59``), for the task boundary to measure."""
        sites = [("conv", 0, 0, round(float(self.radii[0]), 6)),
                 ("kde", 0, round(float(self.radii[0]), 6))]
        for lvl in range(n_levels - 1):
            r = round(float(self.radii[lvl]) * self.conv_radius_scale, 6)
            sites += [("conv", lvl, lvl + 1, r),
                      ("conv", lvl + 1, lvl, r),
                      ("kde", lvl, r),
                      ("kde", lvl + 1, r),
                      ("sweep", lvl, round(float(self.radii[lvl]), 6))]
        return sites

    def forward(
        self,
        points: torch.Tensor,  # (B, N, 3), normalized to the unit cube
        mask: torch.Tensor,  # (B, N) bool
        features: torch.Tensor | None = None,  # (B, N, C); default all-ones
        category_onehot: torch.Tensor | None = None,  # (B, n_categories)
        *,
        hierarchy: PointHierarchy | None = None,
        with_overflow: bool = False,
    ):
        B, N, _ = points.shape
        if features is None:
            features = torch.ones((B, N, 1), dtype=points.dtype, device=points.device)
        if category_onehot is not None:
            cat = category_onehot[:, None, :].expand(B, N, category_onehot.shape[-1])
            features = torch.cat([features, cat.to(features.dtype)], dim=-1)
        hier = hierarchy
        if hier is None:
            hier = build_hierarchy(points, mask, self.radii, neighbor_k=self.neighbor_k,
                                   global_level=False, tile_pairs=self.tile_pairs,
                                   tile_steps=self.tile_steps)
        cache = SpatialCache(hier, tile_pairs=self.tile_pairs, tile_steps=self.tile_steps,
                             conv_backend=self.conv_backend)
        for lvl in hier.levels:
            if lvl.sample is not None and lvl.sample.overflow is not None:
                cache.report_tile_overflow(lvl.sample.overflow)
        n_levels = len(hier)

        x = self.convs["stem"](cache, 0, 0, self.radii[0], features)
        x = self.bns["stem_bn"](x, mask)
        skips = [x]
        for lvl in range(n_levels - 1):
            radius = self.radii[lvl] * self.conv_radius_scale
            out_mask = hier.levels[lvl + 1].mask
            x = self.convs[f"enc_{lvl}_{lvl + 1}"](cache, lvl, lvl + 1, radius, x)
            x = self.bns[f"enc_bn_{lvl + 1}"](x, out_mask)
            x = self.mixes[f"enc_mix_{lvl + 1}"](x)
            x = self.bns[f"enc_mix_bn_{lvl + 1}"](x, out_mask)
            if lvl + 1 < n_levels - 1:
                skips.append(x)
        for lvl in range(n_levels - 2, -1, -1):
            radius = self.radii[lvl] * self.conv_radius_scale
            out_mask = hier.levels[lvl].mask
            x = self.convs[f"dec_{lvl + 1}_{lvl}"](cache, lvl + 1, lvl, radius, x)
            x = self.bns[f"dec_bn_{lvl}"](x, out_mask)
            x = torch.cat([x, skips[lvl]], dim=-1)
            x = self.mixes[f"dec_mix_{lvl}"](x)
            x = self.bns[f"dec_mix_bn_{lvl}"](x, out_mask)
        logits = torch.where(mask[..., None], self.logits(x), 0.0)

        counts = cache.drain_tile_overflow()
        overflow = (torch.stack([c.max() for c in counts]).max() if counts
                    else torch.zeros((), dtype=torch.int64, device=points.device))
        if with_overflow:
            return logits, overflow
        if counts and int(overflow) > 0:
            raise RuntimeError(
                f"tile capacity overflow: {int(overflow)} dropped steps; raise tile_pairs "
                "(tasks.common.Runner re-sizes it in training and evaluation)"
            )
        return logits
