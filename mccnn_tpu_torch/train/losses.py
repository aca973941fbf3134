"""Task losses (port of ``mccnn_tpu/train/losses.py:15-30, 44-65``).

Classification: the mean softmax cross-entropy, MCClassH's joint + per-path
loss and the accuracy. Segmentation: the masked, optionally class-weighted
per-point cross-entropy and the masked accuracy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch (integer labels)."""
    return F.cross_entropy(logits, labels.long())


def classh_loss(logits: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                labels: torch.Tensor, path_weight: float = 0.5) -> torch.Tensor:
    """MCClassH's loss: the joint head's plus ``path_weight`` times the sum of
    the two paths' (``losses.py:20-30``)."""
    joint, a, b = logits
    return classification_loss(joint, labels) + path_weight * (
        classification_loss(a, labels) + classification_loss(b, labels)
    )


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point cross-entropy over the valid points, each weighted by its
    class's weight when given (ScanNet's inverse-frequency weighting)."""
    labels = labels.long()
    ll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                         reduction="none").reshape(labels.shape)
    w = mask.to(ll.dtype)
    if class_weights is not None:
        w = w * class_weights[labels]
    return (ll * w).sum() / w.sum().clamp_min(1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    ok = (logits.argmax(-1) == labels) & mask
    return ok.sum() / mask.sum().clamp_min(1)
