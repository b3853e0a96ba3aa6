"""Train step, loss and evaluation metrics: counterpart of
lemevit_tpu/train/steps.py (cross_entropy_loss, make_train_step,
optax_global_norm, eval_metrics). The JSD / aug-splits step is not ported
yet.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.train.state import TrainState


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over int labels (B,) or soft-target rows (B, K),
    with label smoothing; log-softmax in float32."""
    num_classes = logits.shape[-1]
    if targets.dim() == logits.dim() - 1:
        targets = F.one_hot(targets, num_classes).float()
    if label_smoothing > 0.0:
        targets = (targets * (1.0 - label_smoothing)
                   + label_smoothing / num_classes)
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(targets * logp).sum(dim=-1).mean()


def global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    ts = [t.float() for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


def train_step(state: TrainState, images: torch.Tensor,
               targets: torch.Tensor,
               autocast_dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """One step of ``make_train_step``: forward in train mode (under
    autocast to ``autocast_dtype`` when given), cross-entropy against the
    targets (hard labels or soft rows, smoothing already folded in),
    backward, and every ``grad_accum_steps`` steps the optimizer update at
    the schedule's LR (the mean of the accumulated gradients, clipped to
    ``clip_grad`` global norm as optax.clip_by_global_norm does). The norm
    and the clip cover every parameter that takes a gradient, frozen ones
    (left out of the optimizer's groups) included, as the JAX package
    clips before its freeze mask zeroes their updates; the frozen ones are
    never updated. The EMA follows the parameters after every step.
    Returns {"loss", "grad_norm"} as device tensors (the norm of this
    step's gradients of every parameter, before clipping); reading them
    waits for the device."""
    model = state.model
    model.train()
    k = state.grad_accum_steps
    ctx = (torch.autocast(images.device.type, dtype=autocast_dtype)
           if autocast_dtype is not None else contextlib.nullcontext())
    with ctx:
        logits = model(images)
    loss = cross_entropy_loss(logits, targets)
    params = [p for p in model.parameters() if p.requires_grad]
    # a parameter the forward does not reach gets zeros, as under jax.grad
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    gnorm = global_norm(grads)
    for p, g in zip(params, grads):
        g = g / k if k > 1 else g
        p.grad = g if p.grad is None else p.grad.add_(g)
    state.step += 1
    if state.step % k == 0:
        if state.clip_grad:
            grads = [p.grad for p in params]
            norm = gnorm if k == 1 else global_norm(grads)
            torch._foreach_mul_(grads, torch.clamp(
                state.clip_grad / norm, max=1.0))
        lr = state.schedule(state.updates - 1)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        for p in params:  # frozen ones too: the optimizer does not hold them
            p.grad = None
    if state.ema is not None:
        state.ema.update(model)
    return {"loss": loss.detach(), "grad_norm": gnorm.detach()}


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
