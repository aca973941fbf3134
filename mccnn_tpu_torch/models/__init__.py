"""Models (port of ``mccnn_tpu/models``): the classification zoo (MCClassS,
MCClass, MCClassH) and MCSeg so far."""

from .layers import BatchNormReluDropout, Conv1x1, FullyConnected, MaskedBatchNorm, MCConv
from .mcclass import MCClass
from .mcclass_h import MCClassH
from .mcclass_s import MCClassS
from .mcseg import MCSeg

__all__ = ["BatchNormReluDropout", "Conv1x1", "FullyConnected", "MCClass", "MCClassH",
           "MCClassS", "MCConv", "MCSeg", "MaskedBatchNorm"]
