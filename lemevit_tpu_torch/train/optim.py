"""Optimizer and LR schedule factory: counterpart of
lemevit_tpu/train/optim.py, with the same hyperparameters of record: AdamW
betas (0.9, 0.999), eps 1e-8, weight decay 0.05 on parameters of two or
more dimensions except ``meta_tokens``; a linear warmup from warmup_lr into
the main schedule; the base LR given per 512 images of global batch and
scaled with it.

A schedule is a plain function of the optimizer step (the number of updates
applied so far) with optax's formulas, so its values equal the JAX
package's; so are ``mm_step_schedule`` (the detection schedule) and
``warmup_poly_schedule`` (the segmentation schedule, cli/train_seg.py).

``build_optimizer`` takes every ``--opt`` name of the JAX package. A
``torch.optim`` class runs the update where it computes optax's function
(AdamW; Adam and SGD with L2 decay); ``RMSpropTF``, ``Adagrad`` and
``Lamb`` below reproduce the optax chains torch has no class for. Clipping
and gradient accumulation are done by the train step (train/steps.py), as
optax's chain and ``MultiSteps`` do them.

``--sched plateau`` is two halves, as in the JAX package: the schedule
holds the peak after the warmup, and ``PlateauController`` (host side, fed
the eval metric once per epoch) decays a scale that multiplies the final
update of the chain. The scale lives in every parameter group as
``plateau_scale``, so it is part of the optimizer's ``state_dict`` and a
checkpoint keeps it.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

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
    """LR at optimizer step t: cosine (default), step, multistep, poly,
    constant or plateau (the peak; see PlateauController) after the shared
    linear warmup (the JAX package's build_lr_schedule, value for
    value)."""
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
    elif sched in ("constant", "none", "plateau"):
        # plateau: the metric-driven decay is the optimizer's plateau_scale
        def main(t):
            return peak
    else:
        raise ValueError(f"unknown sched {sched!r}")

    def schedule(t: int) -> float:
        return warmup(t) if t < warmup_steps else main(t - warmup_steps)

    return schedule


def mm_step_schedule(base_lr: float, steps_per_epoch: int,
                     milestones: Sequence[float] = (8, 11),
                     gamma: float = 0.1, warmup_iters: int = 500,
                     warmup_ratio: float = 1e-3) -> Schedule:
    """mmcv's StepLrUpdater with linear warmup, the detection schedule of
    record (lemevit_tpu/train/optim.py:85-104): the warmup is in iterations
    with mmcv's ramp 1 - (1 - s / w)(1 - ratio); the LR decays by ``gamma``
    at each milestone, counted in epochs from the start."""
    ms = [float(m) * steps_per_epoch for m in milestones]

    def schedule(t: int) -> float:
        s = float(t)
        warm = (1.0 - (1.0 - s / max(warmup_iters, 1)) * (1.0 - warmup_ratio)
                if s < warmup_iters else 1.0)
        return base_lr * warm * gamma ** sum(s >= m for m in ms)

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


class PlateauController:
    """Host-side ReduceLROnPlateau (the timm ``--sched plateau`` surface;
    lemevit_tpu/train/optim.py:131-174): feed it the eval metric once per
    epoch; the scale decays by ``decay_rate`` after ``patience`` epochs
    without an improvement larger than ``threshold``, then waits
    ``cooldown`` epochs, and never goes below ``min_scale``. Apply the
    returned scale with set_plateau_scale."""

    def __init__(self, decay_rate: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, mode: str = "max",
                 cooldown: int = 0, min_scale: float = 1e-3):
        self.decay_rate = decay_rate
        self.patience = patience
        self.threshold = threshold
        self.mode = mode
        self.cooldown = cooldown
        self.min_scale = min_scale
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.cooldown_left = 0
        self.scale = 1.0

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best + self.threshold
        return metric < self.best - self.threshold

    def update(self, metric: float) -> float:
        """Record one eval metric; returns the (possibly decayed) scale."""
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.decay_rate,
                                 self.min_scale)
                self.bad_epochs = 0
                self.cooldown_left = self.cooldown
        return self.scale


def set_plateau_scale(optimizer: torch.optim.Optimizer, scale: float
                      ) -> None:
    """Make ``scale`` multiply the optimizer's next updates (the JAX
    package's set_plateau_scale on its injected step_size)."""
    for group in optimizer.param_groups:
        group["plateau_scale"] = float(scale)


def plateau_scale(optimizer: torch.optim.Optimizer) -> float:
    return optimizer.param_groups[0].get("plateau_scale", 1.0)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Give every group the schedule's LR for the next update. The plateau
    scale multiplies the chain's final update: this module's rules apply
    it themselves (RMSpropTF must, its momentum trace follows the LR);
    torch's AdamW, Adam and SGD end in the LR, so it folds into theirs."""
    fold = not getattr(optimizer, "applies_plateau_scale", False)
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("plateau_scale", 1.0) if fold else lr


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to parameter ``name`` (the JAX
    package's _wd_mask): tensors of two or more dimensions, except the meta
    tokens."""
    return p.ndim >= 2 and name.split(".")[-1] != "meta_tokens"


def param_groups(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 weight_decay: float, frozen_prefixes: Sequence[str] = ()
                 ) -> List[dict]:
    """Parameter groups: decayed and not decayed, each with a plateau
    scale of 1. Parameters whose name starts with one of
    ``frozen_prefixes`` (port names, e.g. "downsample_layers.0" or
    "stages.0") are left out, so they are never updated (the JAX package
    zeroes their updates)."""
    groups = {True: [], False: []}
    for name, p in named_params:
        if any(name.startswith(f) for f in frozen_prefixes):
            continue
        groups[decays(name, p)].append(p)
    return [{"params": groups[True], "weight_decay": weight_decay,
             "plateau_scale": 1.0},
            {"params": groups[False], "weight_decay": 0.0,
             "plateau_scale": 1.0}]


class _Rule(torch.optim.Optimizer):
    """An optax chain torch has no class for, over each group's parameters
    with ``torch._foreach_*`` ops. Every group holds ``lr``,
    ``weight_decay`` and ``plateau_scale``; the rule multiplies its final
    update by the scale."""

    applies_plateau_scale = True

    def __init__(self, params, **defaults):
        super().__init__(params, dict(defaults, lr=0.0, plateau_scale=1.0))

    def _buffers(self, params: List[torch.Tensor], name: str,
                 init: float) -> List[torch.Tensor]:
        """Each parameter's state ``name``, made as ``init`` at first use."""
        out = []
        for p in params:
            st = self.state[p]
            if name not in st:
                st[name] = torch.full_like(p, init,
                                           memory_format=torch.preserve_format)
            out.append(st[name])
        return out

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params, [p.grad for p in params])
        return loss

    @staticmethod
    def _l2(group, params, grads):
        """optax.add_decayed_weights ahead of the rule (timm's L2 into the
        gradients): g + wd p, as new tensors."""
        if group["weight_decay"]:
            return torch._foreach_add(grads, params,
                                      alpha=group["weight_decay"])
        return [g.clone() for g in grads]

    def _update(self, group, params, grads):
        raise NotImplementedError


class RMSpropTF(_Rule):
    """optax.rmsprop(lr, decay, eps, momentum) after the masked L2 decay:
    chain(add_decayed_weights(wd), scale_by_rms(decay, eps,
    initial_scale=0, eps_in_sqrt=True), scale_by_learning_rate(lr),
    trace(momentum)), then the plateau scale:

        g += wd p;  nu = decay nu + (1 - decay) g^2        (nu from 0)
        u = lr g / sqrt(nu + eps);  buf = momentum buf + u  (momentum > 0)
        p -= scale buf

    ``torch.optim.RMSprop`` puts eps outside the root and multiplies its
    momentum buffer by the LR afterwards, which differs under a changing
    LR."""

    def __init__(self, params, alpha: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, alpha=alpha, eps=eps, momentum=momentum,
                         weight_decay=weight_decay)

    def _update(self, group, params, grads):
        g = self._l2(group, params, grads)
        nu = self._buffers(params, "nu", 0.0)
        torch._foreach_mul_(nu, group["alpha"])
        torch._foreach_addcmul_(nu, g, g, value=1 - group["alpha"])
        den = torch._foreach_add(nu, group["eps"])
        torch._foreach_rsqrt_(den)
        torch._foreach_mul_(g, den)
        torch._foreach_mul_(g, group["lr"])
        if group["momentum"]:
            buf = self._buffers(params, "momentum_buffer", 0.0)
            torch._foreach_mul_(buf, group["momentum"])
            torch._foreach_add_(buf, g)
            g = buf
        torch._foreach_add_(params, g, alpha=-group["plateau_scale"])


class Adagrad(_Rule):
    """optax.adagrad(lr, eps) after the masked L2 decay:
    chain(add_decayed_weights(wd), scale_by_rss(initial_accumulator_value
    0.1, eps), scale_by_learning_rate(lr)), then the plateau scale:

        g += wd p;  acc += g^2  (acc from 0.1);  p -= scale lr g / sqrt(acc + eps)

    ``torch.optim.Adagrad`` starts its sum at 0 and puts eps outside the
    root."""

    def __init__(self, params, eps: float = 1e-8,
                 initial_accumulator_value: float = 0.1,
                 weight_decay: float = 0.0):
        super().__init__(params, eps=eps, weight_decay=weight_decay,
                         initial_accumulator_value=initial_accumulator_value)

    def _update(self, group, params, grads):
        g = self._l2(group, params, grads)
        acc = self._buffers(params, "sum",
                            group["initial_accumulator_value"])
        torch._foreach_addcmul_(acc, g, g)
        # optax's where(acc > 0, rsqrt(acc + eps), 0): acc > 0 from a
        # positive start
        den = torch._foreach_add(acc, group["eps"])
        torch._foreach_rsqrt_(den)
        torch._foreach_mul_(g, den)
        torch._foreach_add_(params, g,
                            alpha=-group["lr"] * group["plateau_scale"])


class Lamb(_Rule):
    """optax.lamb(lr, b1, b2, eps, weight_decay, mask): chain(scale_by_adam,
    add_decayed_weights(wd, mask), scale_by_trust_ratio(),
    scale_by_learning_rate(lr)), then the plateau scale:

        u = m_hat / (sqrt(v_hat) + eps) + wd p
        p -= scale lr (|p| / |u|) u    (per tensor; ratio 1 where a norm is 0)

    PyTorch has no LAMB. The trust ratio applies to every tensor; the decay
    only to the decayed group's."""

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, betas=tuple(betas), eps=eps,
                         weight_decay=weight_decay)

    def _update(self, group, params, grads):
        b1, b2 = group["betas"]
        m = self._buffers(params, "exp_avg", 0.0)
        v = self._buffers(params, "exp_avg_sq", 0.0)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        # one count per group, as optax's per-chain count
        t = self.state[params[0]].get("step", 0) + 1
        for p in params:
            self.state[p]["step"] = t
        u = torch._foreach_div(m, 1 - b1 ** t)
        den = torch._foreach_div(v, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(u, den)
        if group["weight_decay"]:
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
        pn = torch._foreach_norm(params)
        un = torch._foreach_norm(u)
        ratio = [torch.where((a == 0) | (b == 0), torch.ones_like(a), a / b)
                 for a, b in zip(pn, un)]
        torch._foreach_mul_(u, ratio)
        torch._foreach_add_(params, u,
                            alpha=-group["lr"] * group["plateau_scale"])


OPTIMIZERS = ("adamw", "adam", "sgd", "momentum", "nesterov", "rmsprop",
              "rmsproptf", "lamb", "adagrad")


def build_optimizer(model: torch.nn.Module, weight_decay: float = 0.05,
                    beta1: float = 0.9, beta2: float = 0.999,
                    eps: float = 1e-8, frozen_prefixes: Sequence[str] = (),
                    opt: str = "adamw", momentum: float = 0.9
                    ) -> torch.optim.Optimizer:
    """The ``--opt`` rule over ``model``'s parameters in the two groups of
    param_groups (the JAX package's build_optimizer, the timm
    create_optimizer_v2 names): adamw (decoupled decay), adam (L2),
    sgd / nesterov (Nesterov momentum, as in timm), momentum (heavy-ball),
    rmsprop / rmsproptf (RMSpropTF), lamb (decoupled decay inside the trust
    ratio) and adagrad (L2). ``momentum`` 0 makes the SGD names plain SGD,
    as the JAX package's ``momentum or None``. Weight decay skips 1-D
    tensors and the meta tokens. The train step sets the LR before every
    update (set_lr); any other name raises ValueError."""
    groups = param_groups(model.named_parameters(), weight_decay,
                          frozen_prefixes)
    opt = opt.lower()
    if opt == "adamw":
        return torch.optim.AdamW(groups, lr=0.0, betas=(beta1, beta2),
                                 eps=eps)
    if opt == "adam":
        return torch.optim.Adam(groups, lr=0.0, betas=(beta1, beta2),
                                eps=eps)
    if opt in ("sgd", "momentum", "nesterov"):
        return torch.optim.SGD(groups, lr=0.0, momentum=momentum,
                               nesterov=bool(momentum) and opt != "momentum")
    if opt in ("rmsprop", "rmsproptf"):
        return RMSpropTF(groups, alpha=0.9, eps=eps, momentum=momentum)
    if opt == "lamb":
        return Lamb(groups, betas=(beta1, beta2), eps=eps)
    if opt == "adagrad":
        return Adagrad(groups, eps=eps)
    raise ValueError(f"unknown opt {opt!r}")
