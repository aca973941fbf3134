"""Backend dispatch for the MC convolution (port of ``mccnn_tpu/ops/dispatch.py``).

Routing is by shape and is the same on every device, as ``pick_backend``
routes on the TPU (``dispatch.py:63-79``): ``dense`` when the site fits the
dense envelope, else ``bucket`` when ``ceil(1/r) >= 4``, else ``jnp`` (the
reference's K-capacity conv). The conv layer promotes ``bucket`` to ``tile``
when the cache holds a tile capacity. The device then picks kernel or plain
version inside each backend. Ported backends: ``dense`` (K1 / K2), ``tile``
(K5 / K6) and ``bucket`` (K9 / K10); ``jnp`` (the K-capacity conv) raises
where it is reached (``models/layers.py``).

A backend is forced as in the reference: ``MCCNN_TPU_CONV_BACKEND`` in the
environment when this module is imported (``_FORCED``, mapped as the
reference's ``conv_backend()`` maps it: ``pallas`` or ``bucket`` -> bucket,
``dense`` / ``jnp`` / ``tile`` as named, anything else auto), consulted where
the caller's ``mode`` is ``auto``; an explicit ``mode`` (``SpatialCache.
conv_backend``, ``tasks.scannet --conv-backend``) forces its own.
"""

from __future__ import annotations

import math
import os

DENSE_MAX_N = 3072  # mccnn_tpu/ops/pallas/dense_conv.py:53, copied for parity
BACKENDS = ("auto", "dense", "tile", "bucket", "jnp")


def _forced_backend(value: str | None) -> str:
    """The reference's ``conv_backend()`` (``mccnn_tpu/ops/dispatch.py:26-35``)
    of one value of ``MCCNN_TPU_CONV_BACKEND``."""
    if value in ("pallas", "bucket"):
        return "bucket"
    if value in ("dense", "jnp", "tile"):
        return value
    return "auto"


# The reference reads the variable at every dispatch; the port reads it once here.
_FORCED = _forced_backend(os.environ.get("MCCNN_TPU_CONV_BACKEND"))


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
    mode: str = "auto",
) -> str:
    """``"dense"``, ``"bucket"`` or ``"jnp"`` by shape, or the forced backend:
    ``mode``, else ``MCCNN_TPU_CONV_BACKEND`` (``_FORCED``)."""
    if mode not in BACKENDS:
        raise ValueError(f"conv backend {mode!r}: expected one of {BACKENDS}")
    if mode == "auto":
        mode = _FORCED
    if mode != "auto":
        return mode
    if dense_fits(n_sources, c_in, c_out, n_samples):
        return "dense"
    if math.ceil(1.0 / radius) >= 4:
        return "bucket"
    return "jnp"
