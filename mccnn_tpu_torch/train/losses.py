"""Task losses (port of ``mccnn_tpu/train/losses.py:15-17, 44-65``).

Classification: the mean softmax cross-entropy and the accuracy. Segmentation:
the masked, optionally class-weighted per-point cross-entropy and the masked
accuracy. ``classh_loss`` comes with MCClassH (ROADMAP queue 1, slice 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch (integer labels)."""
    return F.cross_entropy(logits, labels.long())


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
