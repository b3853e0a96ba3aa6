"""Evaluation metrics: counterpart of lemevit_tpu/train/steps.py::eval_metrics.
The training step is not ported yet."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def eval_metrics(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Per-batch sums (not means) so callers can aggregate exactly: summed
    cross-entropy, top-1 and top-5 hits, and the count. Rows labelled -1
    (padding) add nothing to the sums."""
    logp = F.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    picked = logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    top = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
    return {
        "loss_sum": -(picked * valid).sum(),
        "top1_sum": (top[:, 0] == labels).sum(),
        "top5_sum": (top == labels[:, None]).any(dim=-1).sum(),
        "count": torch.tensor(labels.shape[0]),
    }
