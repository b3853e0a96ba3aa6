"""Train steps, losses and evaluation metrics: counterpart of
lemevit_tpu/train/steps.py (cross_entropy_loss, make_train_step,
jsd_cross_entropy, make_jsd_train_step, stack_batch_stats /
unstack_batch_stats, optax_global_norm, eval_metrics).

Both steps share ``apply_gradients``: gradient accumulation, clipping, the
LR and the EMA. The JSD step runs the model once over the S splits' views
concatenated to an (S B, ...) batch, with every BatchNorm in split mode
(``stack_batch_stats``): each split is normalised with its own batch
statistics and updates its own running set, which is the function of the
JAX package's vmap over splits with stacked ``batch_stats``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import BatchNorm
from lemevit_tpu_torch.train.optim import set_lr
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


def jsd_cross_entropy(logits_s: torch.Tensor, targets: torch.Tensor,
                      alpha: float = 12.0) -> torch.Tensor:
    """JSD consistency loss over aug splits (timm's JsdCrossEntropy; the
    JAX package's jsd_cross_entropy): cross-entropy on the clean split 0
    plus ``alpha`` times the mean over splits and samples of
    KL(p_i || mean_j p_j), in float32 with probabilities clipped to
    [1e-7, 1] under the logarithms. logits_s (S, B, K); targets (B, K) soft
    rows (smoothing folded in)."""
    logits32 = logits_s.float()
    ce = -(targets * F.log_softmax(logits32[0], dim=-1)).sum(dim=-1).mean()
    probs = F.softmax(logits32, dim=-1)
    mix = probs.mean(dim=0).clamp(1e-7, 1.0)
    kl = (probs * (probs.clamp(1e-7, 1.0).log() - mix.log()[None])).sum(-1)
    return ce + alpha * kl.mean()


def batch_norms(model: torch.nn.Module):
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def stack_batch_stats(model: torch.nn.Module, num_splits: int) -> None:
    """Put every BatchNorm of ``model`` in split mode: ``num_splits`` sets
    of running statistics, each a copy of the current ones (the JAX
    package's stack_batch_stats)."""
    for bn in batch_norms(model):
        bn.set_splits(num_splits)


def unstack_batch_stats(model: torch.nn.Module) -> None:
    """Leave split mode, keeping the clean split's (set 0) statistics, the
    set that eval mode uses (the JAX package's unstack_batch_stats)."""
    for bn in batch_norms(model):
        bn.set_splits(1)


def _forward(model: torch.nn.Module, images: torch.Tensor,
             autocast_dtype: Optional[torch.dtype]) -> torch.Tensor:
    model.train()
    ctx = (torch.autocast(images.device.type, dtype=autocast_dtype)
           if autocast_dtype is not None else contextlib.nullcontext())
    with ctx:
        return model(images)


def apply_gradients(state: TrainState, params: List[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    gnorm: Optional[torch.Tensor] = None) -> None:
    """One train step's gradients ``grads`` of ``params`` into ``state``:
    accumulated (their mean over ``grad_accum_steps`` steps, as
    optax.MultiSteps), and every ``grad_accum_steps`` steps clipped to
    ``clip_grad`` global norm (optax.clip_by_global_norm) and applied at
    the schedule's LR (set_lr, which carries the plateau scale). The norm
    and the clip cover every parameter given, frozen ones (left out of the
    optimizer's groups) included, as the JAX package clips before its
    freeze mask zeroes their updates; the frozen ones are never updated.
    ``gnorm``, the global norm of ``grads`` when known, spares the clip a
    second one. The EMA follows the parameters after every step."""
    k = state.grad_accum_steps
    for p, g in zip(params, grads):
        g = g / k if k > 1 else g
        p.grad = g if p.grad is None else p.grad.add_(g)
    state.step += 1
    if state.step % k == 0:
        if state.clip_grad:
            grads = [p.grad for p in params]
            norm = gnorm if k == 1 and gnorm is not None else global_norm(
                grads)
            torch._foreach_mul_(grads, torch.clamp(
                state.clip_grad / norm, max=1.0))
        set_lr(state.optimizer, state.schedule(state.updates - 1))
        state.optimizer.step()
        for p in params:  # frozen ones too: the optimizer does not hold them
            p.grad = None
    if state.ema is not None:
        state.ema.update(state.model)


def _backward_and_update(state: TrainState, loss: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    params = [p for p in state.model.parameters() if p.requires_grad]
    # a parameter the forward does not reach gets zeros, as under jax.grad
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    gnorm = global_norm(grads)
    apply_gradients(state, params, grads, gnorm)
    return {"loss": loss.detach(), "grad_norm": gnorm.detach()}


def train_step(state: TrainState, images: torch.Tensor,
               targets: torch.Tensor,
               autocast_dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """One step of ``make_train_step``: forward in train mode (under
    autocast to ``autocast_dtype`` when given), cross-entropy against the
    targets (hard labels or soft rows, smoothing already folded in),
    backward and apply_gradients. Returns {"loss", "grad_norm"} as device
    tensors (the norm of this step's gradients of every parameter, before
    clipping); reading them waits for the device."""
    logits = _forward(state.model, images, autocast_dtype)
    return _backward_and_update(state, cross_entropy_loss(logits, targets))


def jsd_train_step(state: TrainState, images: torch.Tensor,
                   targets: torch.Tensor, alpha: float = 12.0,
                   autocast_dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """One step of ``make_jsd_train_step``: images (S, B, H, W, C), split 0
    the clean views; targets (B, K) soft rows. One forward over the (S B)
    views with the model's BatchNorms in split mode of S sets
    (stack_batch_stats), the JSD loss, then as train_step. Returns
    {"loss", "grad_norm"}."""
    s, b = images.shape[:2]
    bad = [bn for bn in batch_norms(state.model) if bn.num_splits != s]
    if bad:
        raise ValueError(f"{len(bad)} BatchNorms hold {bad[0].num_splits} "
                         f"statistics sets for {s} splits (call "
                         "stack_batch_stats(model, num_splits) first)")
    logits = _forward(state.model, images.flatten(0, 1), autocast_dtype)
    loss = jsd_cross_entropy(logits.unflatten(0, (s, b)), targets, alpha)
    return _backward_and_update(state, loss)


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
