"""Task losses (port of ``mccnn_tpu/train/losses.py:15-17, 59-60``).

The classification slice needs the mean softmax cross-entropy and the
accuracy; ``classh_loss`` comes with MCClassH (ROADMAP queue 1, slice 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch (integer labels)."""
    return F.cross_entropy(logits, labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
