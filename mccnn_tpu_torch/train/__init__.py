"""Training: losses, optimizer, train state and step, metrics, checkpoints
(port of ``mccnn_tpu/train``)."""

from .losses import (
    accuracy,
    classh_loss,
    classification_loss,
    iou_per_class,
    masked_accuracy,
    normal_loss,
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
    "iou_per_class",
    "make_optimizer",
    "make_train_step",
    "masked_accuracy",
    "normal_loss",
    "segmentation_loss",
]
