"""Optimizer and LR schedule factory: counterpart of
lemevit_tpu/train/optim.py (scaled_lr, build_lr_schedule, build_optimizer's
adamw), with the same hyperparameters of record: AdamW betas (0.9, 0.999),
eps 1e-8, weight decay 0.05 on parameters of two or more dimensions except
``meta_tokens``; a linear warmup from warmup_lr into the main schedule; the
base LR given per 512 images of global batch and scaled with it.

A schedule is a plain function of the optimizer step (the number of updates
applied so far) with optax's formulas, so its values equal the JAX
package's. ``torch.optim.AdamW`` takes the update; its decoupled decay
``p -= lr * wd * p`` is optax's ``adamw`` mask-applied decay. Clipping and
gradient accumulation are done by the train step (train/steps.py), as
optax's chain does them. ``warmup_poly_schedule`` is the segmentation
schedule (cli/train_seg.py). The plateau schedule, the detection schedule
and the other optimizers are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def scaled_lr(base_lr: float, global_batch_size: int,
              base_batch: int = 512, scaling: str = "linear") -> float:
    if scaling == "none":
        return base_lr
    ratio = global_batch_size / base_batch
    if scaling == "sqrt":
        ratio = ratio ** 0.5
    return base_lr * ratio


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    return lambda t: init + (end - init) * min(max(t, 0), steps) / steps


def build_lr_schedule(
    base_lr: float = 5e-4,
    global_batch_size: int = 512,
    steps_per_epoch: int = 1000,
    epochs: int = 280,
    warmup_epochs: int = 5,
    warmup_lr: float = 1e-6,
    min_lr: float = 1e-5,
    scaling: str = "linear",
    sched: str = "cosine",
    decay_epochs: float = 90,
    decay_rate: float = 0.1,
    decay_milestones: Sequence[float] = (),
    power: float = 1.0,
) -> Schedule:
    """LR at optimizer step t: cosine (default), step, multistep, poly or
    constant after the shared linear warmup (the JAX package's
    build_lr_schedule, value for value)."""
    peak = scaled_lr(base_lr, global_batch_size, scaling=scaling)
    warmup_steps = max(int(warmup_epochs * steps_per_epoch), 1)
    total_steps = max(int(epochs * steps_per_epoch), warmup_steps + 1)
    warmup = _linear(warmup_lr, peak, warmup_steps)
    if sched == "cosine":
        alpha = 0.0 if peak == 0.0 else min_lr / peak
        decay = total_steps - warmup_steps

        def main(t):
            cos = 0.5 * (1 + math.cos(math.pi * min(t, decay) / decay))
            return peak * ((1 - alpha) * cos + alpha)
    elif sched in ("step", "multistep"):
        # milestones count epochs from the start of training; the main
        # schedule starts after the warmup
        if sched == "step":
            ms = [k * decay_epochs for k in
                  range(1, int(epochs / max(decay_epochs, 1e-9)) + 1)]
        else:
            ms = list(decay_milestones)
        bounds = sorted({max(int(m * steps_per_epoch) - warmup_steps, 1):
                         decay_rate for m in ms}.items())

        def main(t):
            v = peak
            for b, r in bounds:
                if t >= b:
                    v *= r
            return v
    elif sched == "poly":
        span = total_steps - warmup_steps

        def main(t):
            frac = 1 - min(max(t, 0), span) / span
            return (peak - min_lr) * frac ** power + min_lr
    elif sched in ("constant", "none"):
        def main(t):
            return peak
    else:
        raise ValueError(f"unknown or unported sched {sched!r}")

    def schedule(t: int) -> float:
        return warmup(t) if t < warmup_steps else main(t - warmup_steps)

    return schedule


def warmup_poly_schedule(base_lr: float, total_steps: int,
                         power: float = 1.0, min_lr: float = 0.0,
                         warmup_iters: int = 1500,
                         warmup_ratio: float = 1e-6) -> Schedule:
    """mmcv's poly policy with linear warmup, the segmentation schedule of
    record (lemevit_tpu/train/optim.py:107-128): progress is s / total with
    no warmup offset, and the warmup factor multiplies the poly value, so
    at s = 1500 of 80000 the LR is base_lr (1 - 1500 / 80000)."""
    def schedule(t: int) -> float:
        s = float(t)
        warm = (1.0 - (1.0 - s / max(warmup_iters, 1)) * (1.0 - warmup_ratio)
                if s < warmup_iters else 1.0)
        frac = min(max(s / max(total_steps, 1), 0.0), 1.0)
        return ((base_lr - min_lr) * (1.0 - frac) ** power + min_lr) * warm

    return schedule


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to parameter ``name`` (the JAX
    package's _wd_mask): tensors of two or more dimensions, except the meta
    tokens."""
    return p.ndim >= 2 and name.split(".")[-1] != "meta_tokens"


def param_groups(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 weight_decay: float, frozen_prefixes: Sequence[str] = ()
                 ) -> List[dict]:
    """AdamW parameter groups: decayed and not decayed. Parameters whose
    name starts with one of ``frozen_prefixes`` (port names, e.g.
    "downsample_layers.0" or "stages.0") are left out, so they are never
    updated (the JAX package zeroes their updates)."""
    groups = {True: [], False: []}
    for name, p in named_params:
        if any(name.startswith(f) for f in frozen_prefixes):
            continue
        groups[decays(name, p)].append(p)
    return [{"params": groups[True], "weight_decay": weight_decay},
            {"params": groups[False], "weight_decay": 0.0}]


def build_optimizer(model: torch.nn.Module, weight_decay: float = 0.05,
                    beta1: float = 0.9, beta2: float = 0.999,
                    eps: float = 1e-8, frozen_prefixes: Sequence[str] = (),
                    opt: str = "adamw") -> torch.optim.Optimizer:
    """AdamW over ``model``'s parameters in the two groups of param_groups.
    The learning rate is set by the train step from its schedule before
    every update."""
    if opt.lower() != "adamw":
        raise NotImplementedError(f"--opt {opt} is not ported yet (adamw)")
    return torch.optim.AdamW(
        param_groups(model.named_parameters(), weight_decay, frozen_prefixes),
        lr=0.0, betas=(beta1, beta2), eps=eps)
