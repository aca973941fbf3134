"""Training: losses, optimizer, train state and step, metrics, checkpoints
(port of ``mccnn_tpu/train``)."""

from .losses import (
    accuracy,
    classh_loss,
    classification_loss,
    masked_accuracy,
    segmentation_loss,
)
from .state import (
    TrainState,
    batch_to_device,
    init_state,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "TrainState",
    "accuracy",
    "batch_to_device",
    "classh_loss",
    "classification_loss",
    "init_state",
    "make_optimizer",
    "make_train_step",
    "masked_accuracy",
    "segmentation_loss",
]
