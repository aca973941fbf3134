"""Backend dispatch for the MC convolution (port of ``mccnn_tpu/ops/dispatch.py``).

This slice has one backend, ``dense`` (``ops/cuda/dense_conv.py``): the CUDA
kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor. A CUDA
conv site outside ``dense_fits`` would need the bucket or tile kernels, which
are not ported yet, so it raises. No environment variable switches backends.
"""

from __future__ import annotations

import torch

DENSE_MAX_N = 3072  # mccnn_tpu/ops/pallas/dense_conv.py:53, copied for parity


def dense_fits(n_sources: int, c_in: int, c_out: int | None,
               n_samples: int | None = None) -> bool:
    """The reference's envelope for the dense kernel, copied as is so that
    dispatch matches the JAX package (``mccnn_tpu/ops/dispatch.py:38-60``).
    Its thresholds were sized for TPU VMEM, not for the H100."""
    c_eff = max(c_in, c_out or 0, 128)
    m = n_sources if n_samples is None else n_samples
    return (
        n_sources <= DENSE_MAX_N
        and n_sources * c_eff <= 3072 * 256
        and m * c_eff <= 3072 * 128
    )


def pick_backend(
    n_sources: int,
    radius: float,
    c_in: int,
    c_out: int | None,
    n_samples: int | None = None,
    *,
    device: torch.device,
) -> str:
    """``"dense"``, or ``NotImplementedError`` for a CUDA site outside the envelope."""
    del radius  # the bucket/tile choice that reads it is not ported yet
    if torch.device(device).type == "cpu" or dense_fits(n_sources, c_in, c_out, n_samples):
        return "dense"
    raise NotImplementedError(
        f"conv site N={n_sources}, M={n_samples}, C={c_in}->{c_out} is outside "
        "the dense envelope; the bucket (K9) and tile (K5) kernels are ported "
        "with the big-scene slice (ROADMAP queue 2)"
    )
