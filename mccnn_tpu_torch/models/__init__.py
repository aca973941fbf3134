"""Models (port of ``mccnn_tpu/models``): the classification zoo (MCClassS,
MCClass, MCClassH), normal estimation (MCNorm, MCNormS) and MCSeg."""

from .layers import BatchNormReluDropout, Conv1x1, FullyConnected, MaskedBatchNorm, MCConv
from .mcclass import MCClass
from .mcclass_h import MCClassH
from .mcclass_s import MCClassS
from .mcnorm import MCNorm, MCNormS
from .mcseg import MCSeg

__all__ = ["BatchNormReluDropout", "Conv1x1", "FullyConnected", "MCClass", "MCClassH",
           "MCClassS", "MCConv", "MCNorm", "MCNormS", "MCSeg", "MaskedBatchNorm"]
