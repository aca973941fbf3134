"""Models (port of ``mccnn_tpu/models``): MCClassS and MCSeg so far."""

from .layers import BatchNormReluDropout, Conv1x1, FullyConnected, MaskedBatchNorm, MCConv
from .mcclass_s import MCClassS
from .mcseg import MCSeg

__all__ = ["BatchNormReluDropout", "Conv1x1", "FullyConnected", "MCClassS", "MCConv",
           "MCSeg", "MaskedBatchNorm"]
