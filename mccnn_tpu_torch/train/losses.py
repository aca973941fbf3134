"""Task losses (port of ``mccnn_tpu/train/losses.py``).

Classification: the mean softmax cross-entropy, MCClassH's joint + per-path
loss and the accuracy. Normals: the sign-invariant cosine distance.
Segmentation: the masked, optionally class-weighted per-point cross-entropy,
the masked accuracy and the per-class intersection / union counts.
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


def normal_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """``1 - |cos|`` between predicted and ground-truth normals, averaged over
    the valid points (``losses.py:33-41``): sign-invariant, since a normal
    estimated from points alone has no orientation. The norms get ``+ eps``,
    as in the reference."""
    p = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + eps)
    t = target / (torch.linalg.vector_norm(target, dim=-1, keepdim=True) + eps)
    loss = 1.0 - (p * t).sum(-1).abs()
    m = mask.to(loss.dtype)
    return (loss * m).sum() / m.sum().clamp_min(1.0)


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


def iou_per_class(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(intersection, union) int32 counts per class over the valid points
    (``losses.py:68-84``), to be summed across batches and divided at the end."""
    pred = logits.argmax(-1)
    classes = torch.arange(n_classes, device=logits.device)
    p = (pred[..., None] == classes) & mask[..., None]
    t = (labels[..., None].long() == classes) & mask[..., None]
    dims = tuple(range(p.dim() - 1))
    return (p & t).sum(dims).to(torch.int32), (p | t).sum(dims).to(torch.int32)
