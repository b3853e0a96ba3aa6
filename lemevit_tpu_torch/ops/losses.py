"""Detection and change-detection losses: counterpart of
lemevit_tpu/ops/losses.py, with its reductions.

  - sigmoid_focal_loss: one-vs-all focal loss on (N, C) logits, targets
    index the columns, -1 rows ignored;
  - softmax_focal_loss: the change-detection FocalLoss (gamma 0 is plain
    cross-entropy) on (N, C, ...) logits;
  - dice_loss, jaccard_loss, tversky_loss: soft overlaps of the softmax
    probabilities with the one-hot targets, per class over the batch and
    pixels, then their mean;
  - hybrid_loss: focal + dice, summed over a tuple of outputs (deep
    supervision).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _one_hot(targets: torch.Tensor, num_classes: int, like: torch.Tensor
             ) -> torch.Tensor:
    """One-hot along dim 1, in ``like``'s dtype; out-of-range targets
    (such as -1) give a zero row, as jax.nn.one_hot does."""
    valid = (targets >= 0) & (targets < num_classes)
    t = F.one_hot(targets.clamp(0, num_classes - 1).long(), num_classes)
    t = t * valid[..., None]
    return t.movedim(-1, 1).to(like.dtype)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (optax's form)."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25,
                       reduction: str = "mean") -> torch.Tensor:
    """Focal loss on (N, C) one-vs-all logits; ``targets`` (N,) index the
    columns, rows with target -1 add nothing."""
    c = logits.shape[1]
    t = _one_hot(targets, c, logits)
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, t)
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    loss = alpha_t * (1 - p_t) ** gamma * ce
    loss = torch.where((targets >= 0)[:, None], loss, torch.zeros_like(loss))
    return _reduce(loss, reduction)


def softmax_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 0.0,
                       reduction: str = "mean") -> torch.Tensor:
    """Softmax focal loss on (N, C, ...) or (N, C) logits and int targets
    (N, ...); gamma 0 is the cross-entropy."""
    logp = F.log_softmax(logits, dim=1)
    logpt = (logp * _one_hot(targets, logits.shape[1], logits)).sum(dim=1)
    pt = logpt.exp()
    return _reduce(-((1 - pt) ** gamma) * logpt, reduction)


def _overlaps(logits: torch.Tensor, targets: torch.Tensor):
    probs = F.softmax(logits, dim=1)
    t = _one_hot(targets, logits.shape[1], logits)
    dims = (0,) + tuple(range(2, logits.dim()))
    return probs, t, dims


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    """1 - the mean over classes of the soft dice; logits (N, C, H, W),
    targets int (N, H, W)."""
    probs, t, dims = _overlaps(logits, targets)
    inter = (probs * t).sum(dim=dims)
    card = (probs + t).sum(dim=dims)
    return 1.0 - ((2 * inter + smooth) / (card + smooth + eps)).mean()


def jaccard_loss(logits: torch.Tensor, targets: torch.Tensor,
                 smooth: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    probs, t, dims = _overlaps(logits, targets)
    inter = (probs * t).sum(dim=dims)
    union = (probs + t).sum(dim=dims) - inter
    return 1.0 - ((inter + smooth) / (union + smooth + eps)).mean()


def tversky_loss(logits: torch.Tensor, targets: torch.Tensor,
                 alpha: float = 0.5, beta: float = 0.5,
                 smooth: float = 1.0, eps: float = 1e-7) -> torch.Tensor:
    probs, t, dims = _overlaps(logits, targets)
    tp = (probs * t).sum(dim=dims)
    fp = (probs * (1 - t)).sum(dim=dims)
    fn = ((1 - probs) * t).sum(dim=dims)
    return 1.0 - ((tp + smooth)
                  / (tp + alpha * fp + beta * fn + smooth + eps)).mean()


def hybrid_loss(outputs: Union[torch.Tensor, Sequence[torch.Tensor]],
                targets: torch.Tensor,
                focal_gamma: float = 0.0) -> torch.Tensor:
    """The change-detection hybrid: focal + dice, summed over the outputs
    of a tuple (or one tensor)."""
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    loss = 0.0
    for out in outputs:
        loss = loss + softmax_focal_loss(out, targets, gamma=focal_gamma)
        loss = loss + dice_loss(out, targets)
    return loss
