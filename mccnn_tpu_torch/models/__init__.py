"""Models (port of ``mccnn_tpu/models``): MCClassS so far."""

from .layers import BatchNormReluDropout, FullyConnected, MaskedBatchNorm, MCConv
from .mcclass_s import MCClassS

__all__ = ["BatchNormReluDropout", "FullyConnected", "MCClassS", "MCConv", "MaskedBatchNorm"]
