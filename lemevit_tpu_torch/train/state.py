"""Train state: counterpart of lemevit_tpu/train/state.py. The model holds
the parameters and the BatchNorm statistics, the optimizer its moments, and
``ModelEma`` an exponential moving average of the parameters only: BatchNorm
statistics are shared with the live model, as the JAX package's
``ema_variables`` shares ``batch_stats``. Everything stays float32; the
compute type is the train step's autocast.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.func import functional_call

from lemevit_tpu_torch.train.optim import Schedule


class ModelEma:
    """EMA of a model's parameters: after each update e = e d + (1 - d) p
    (lemevit_tpu/train/state.py:27-33)."""

    def __init__(self, model: torch.nn.Module, decay: float):
        self.decay = decay
        self.params: Dict[str, torch.Tensor] = {
            n: p.detach().clone() for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        ema = list(self.params.values())
        torch._foreach_mul_(ema, self.decay)
        torch._foreach_add_(ema, [p.detach() for p in model.parameters()],
                            alpha=1.0 - self.decay)

    def __call__(self, model: torch.nn.Module, *args):
        """``model``'s forward with the EMA parameters in place of its own
        (its buffers, the BatchNorm statistics, stay the live ones)."""
        return functional_call(model, self.params, args)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.params)

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Take the parameters of ``sd`` (other entries, such as BatchNorm
        statistics, are the live model's business)."""
        missing = set(self.params) - set(sd)
        if missing:
            raise KeyError(f"EMA state lacks {sorted(missing)[:3]}")
        with torch.no_grad():
            for n, e in self.params.items():
                e.copy_(sd[n])


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step. ``step`` counts train
    steps (micro-batches); the optimizer updates every ``grad_accum_steps``
    of them, at the LR ``schedule`` gives for its update count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    ema: Optional[ModelEma] = None
    step: int = 0
    grad_accum_steps: int = 1
    clip_grad: Optional[float] = None
    # the DistributedDataParallel wrapper of ``model`` in a multi-process
    # run: the train steps run their forward through it; checkpoints and
    # the EMA keep to ``model``, so their names carry no "module." prefix
    ddp: Optional[torch.nn.Module] = None

    @property
    def updates(self) -> int:
        """Optimizer updates applied so far."""
        return self.step // self.grad_accum_steps
