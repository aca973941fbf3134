"""Monte-Carlo convolution parameters (port of ``mccnn_tpu/core/mcconv.py:55-84``).

Estimator, per output sample i (density-corrected mode):

  out[i] = sum_{j in N(i)}  g((y_j - x_i)/r) * f[j] / density[j]

with ``g`` the kernel MLP 3 -> H -> Cin ('depthwise') or 3 -> H -> Cin*Cout
('full'). The dense evaluation over all in-radius pairs lives in
``ops/cuda/dense_conv.py``; the K-capacity ``mc_conv`` over neighbour lists
comes with the port of ``core/neighbors.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

KERNEL_HIDDEN = 8  # paper: one hidden layer with 8 neurons


class MCConvParams(NamedTuple):
    """Kernel-MLP parameters. w2 is (H, Cin) for depthwise, (H, Cin*Cout) for full."""

    w1: torch.Tensor  # (3, H)
    b1: torch.Tensor  # (H,)
    w2: torch.Tensor  # (H, Cin) | (H, Cin*Cout)
    b2: torch.Tensor  # matching w2's trailing dim


def init_mcconv_params(
    generator: torch.Generator,
    c_in: int,
    c_out: int | None = None,
    hidden: int = KERNEL_HIDDEN,
    dtype=torch.float32,
    device=None,
) -> MCConvParams:
    """He-style init for the kernel MLP (``c_out=None`` -> depthwise)."""
    out_dim = c_in if c_out is None else c_in * c_out
    w1 = torch.randn((3, hidden), generator=generator, dtype=dtype) * (2.0 / 3.0) ** 0.5
    w2 = torch.randn((hidden, out_dim), generator=generator, dtype=dtype) * (
        2.0 / hidden
    ) ** 0.5
    params = MCConvParams(
        w1=w1,
        b1=torch.zeros((hidden,), dtype=dtype),
        w2=w2,
        b2=torch.zeros((out_dim,), dtype=dtype),
    )
    return MCConvParams(*(t.to(device) for t in params))
