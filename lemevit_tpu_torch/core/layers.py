"""Core layers of the PyTorch port of LeMeViT.

Spatial tensors are NHWC at every public boundary, as in the JAX package;
the convolutions run on a channels-last NCHW view of the same memory, so the
layout change costs no copy. Token tensors are (B, N, C).

Counterpart of ``lemevit_tpu/core/layers.py``. Module and parameter names
follow the reference PyTorch checkpoints (``downsample_layers.0.{0,1,3,4}``,
``meta_token_downsample.i.{0,1,3,4}``, ``mlp.{0,3}``), so those load with
``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.parallel.distributed import (all_reduce_sum_grad,
                                                    group_active)


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, std) truncated at +-2 std (the JAX package's trunc_normal_init)."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def torch_default_(weight: torch.Tensor, bias: Optional[torch.Tensor],
                   fan_in: int,
                   generator: Optional[torch.Generator] = None) -> None:
    """torch's Conv2d default: weight and bias U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    nn.init.uniform_(weight, -bound, bound, generator=generator)
    if bias is not None:
        nn.init.uniform_(bias, -bound, bound, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``model`` from ``generator``, with the
    distributions of the JAX package: convs torch-default, Linear
    trunc-normal(0.02) with zero bias, norms one and zero, meta tokens
    N(0, 1)."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels // mod.groups * math.prod(
                mod.kernel_size)
            torch_default_(mod.weight, mod.bias, fan_in, generator)
        elif isinstance(mod, nn.Linear):
            trunc_normal_(mod.weight, generator=generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
            if isinstance(mod, nn.BatchNorm2d):
                mod.reset_running_stats()
    for name, p in model.named_parameters(recurse=True):
        if name.endswith("meta_tokens"):
            nn.init.normal_(p, 0.0, 1.0, generator=generator)


def nhwc_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW module to an NHWC tensor through channels-last views."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode update of ``running_var`` takes the
    *biased* batch variance, as flax's BatchNorm does (torch's takes the
    unbiased one); momentum 0.1 here is flax's 0.9. Statistics in fp32;
    eval mode is torch's own.

    Split mode (``set_splits(S)``, S > 1; timm's split BatchNorm of an
    AugMix run) holds S sets of running statistics, (S, C) each. In train
    mode an (S B, C, H, W) batch is S splits of B rows, and each split is
    normalised with its own batch statistics and updates its own set; eval
    mode uses set 0, the clean split's.

    Under a process group of more than one rank (SyncBN, JAX's BatchNorm
    with ``axis_name="data"`` under pjit) the train-mode statistics are
    those of the global batch, per split: the per-channel sums and then the
    centred sums of squares are all-reduced (``all_reduce_sum_grad``, whose
    backward all-reduces their gradients, so the gradient runs through the
    reduction), the rows are normalised with the global mean and biased
    variance, and the running statistics follow the global values. With
    one process the local path below runs, as before."""

    num_splits = 1

    def set_splits(self, num_splits: int) -> None:
        """Enter split mode with ``num_splits`` copies of the current
        statistics (set 0's when already split), or leave it with
        ``num_splits`` 1, keeping set 0's."""
        for name in ("running_mean", "running_var"):
            t = getattr(self, name)
            if self.num_splits > 1:
                t = t[0]
            setattr(self, name, t[None].repeat(num_splits, 1)
                    if num_splits > 1 else t.clone())
        self.num_splits = num_splits

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            if self.num_splits == 1:
                mean, var = mean[0], var[0]
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked.add_(1)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the process group (see the class docstring)."""
        s = self.num_splits
        x32 = x.float().unflatten(0, (s, -1))         # (S, B, C, H, W)
        dims = (1, 3, 4)
        count = x32.shape[1] * x32.shape[3] * x32.shape[4]
        sums = x32.sum(dim=dims)                      # (S, C)
        # in float64, so that the global count stays exact
        tot = all_reduce_sum_grad(torch.cat([
            sums.flatten().double(),
            torch.tensor([count], dtype=torch.float64, device=x.device)]))
        n = tot[-1].detach()
        mean = (tot[:-1] / n).float().view_as(sums)
        d = x32 - mean[:, None, :, None, None]
        var = all_reduce_sum_grad(d.square().sum(dim=dims)) / n
        self._update_running(mean.detach(), var.detach())
        inv = torch.rsqrt(var + self.eps)[:, None, :, None, None]
        y = (d * inv * self.weight.float()[:, None, None]
             + self.bias.float()[:, None, None])
        return y.flatten(0, 1).to(x.dtype)

    def forward(self, x):
        s = self.num_splits
        if not self.training:
            mean, var = self.running_mean, self.running_var
            if s > 1:
                mean, var = mean[0], var[0]
            return F.batch_norm(x, mean, var, self.weight, self.bias, False,
                                0.0, self.eps)
        if group_active():
            return self._synced(x)
        with torch.no_grad():
            x32 = x.float().unflatten(0, (s, -1))
            self._update_running(x32.mean(dim=(1, 3, 4)),
                                 x32.var(dim=(1, 3, 4), unbiased=False))
        # the splits' channels side by side, (B, S C, H, W) (a view when S
        # is 1): one batch_norm normalises each split with its own
        # statistics
        xs = x.unflatten(0, (s, -1)).transpose(0, 1).flatten(1, 2)
        y = F.batch_norm(xs, None, None, self.weight.repeat(s),
                         self.bias.repeat(s), True, 0.0, self.eps)
        return y.unflatten(1, (s, -1)).transpose(0, 1).flatten(0, 1)


class ConvBN(nn.Sequential):
    """3x3 stride-2 conv + BatchNorm, NHWC in and out: a stage downsample
    (children 0 conv, 1 bn)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.Conv2d(in_ch, out_ch, 3, 2, 1),
                         BatchNorm(out_ch, eps=1e-5))

    def forward(self, x):
        return nhwc_conv(super().forward, x)


class ConvStem(nn.Sequential):
    """Two 3x3 stride-2 conv + BN, exact-erf GELU between: image -> H/4
    tokens (children 0 conv, 1 bn, 2 GELU, 3 conv, 4 bn)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(
            nn.Conv2d(in_ch, features // 2, 3, 2, 1),
            BatchNorm(features // 2, eps=1e-5),
            nn.GELU(),
            nn.Conv2d(features // 2, features, 3, 2, 1),
            BatchNorm(features, eps=1e-5))

    def forward(self, x):
        return nhwc_conv(super().forward, x)


class DWConv(nn.Conv2d):
    """Depthwise conv (3x3 by default) on NHWC maps, or on (B, N, C) tokens
    given hw=(H, W): the conditional position embedding (CPE) of every
    block, and the optional MLP dwconv."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__(dim, dim, kernel_size, padding=kernel_size // 2,
                         groups=dim)

    def forward(self, x, hw: Optional[tuple] = None):
        if x.dim() == 3:
            if hw is None:
                raise ValueError("DWConv on (B,N,C) tokens needs hw=(H,W)")
            b, n, c = x.shape
            return nhwc_conv(super().forward,
                             x.reshape(b, *hw, c)).reshape(b, n, c)
        return nhwc_conv(super().forward, x)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch; identity in eval
    mode or at rate 0. The keep masks are drawn from ``generator``, a
    ``torch.Generator`` on the activations' device that the training loop
    sets (``LeMeViT.set_generator``) and seeds from its --seed, so a run is
    reproducible; training at a rate above 0 without one raises. With a
    ``shard`` (rank, world) of a data-parallel run, the masks are drawn for
    the global batch of world x batch rows, one value per global row, and
    this rank keeps its block of them, as the JAX package draws over the
    global batch."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[Tuple[int, int]] = None

    def scales(self, n: int, batch: int, device) -> Optional[torch.Tensor]:
        """(n, batch) float32 branch scales keep_mask / keep on ``device``
        (n independent draws per sample), or None where DropPath is the
        identity (eval mode or rate 0)."""
        if self.rate == 0.0 or not self.training:
            return None
        g = self.generator
        if g is None:
            raise RuntimeError("DropPath at rate > 0 in training needs a "
                               "torch.Generator (LeMeViT.set_generator)")
        keep = 1.0 - self.rate
        rank, world = self.shard or (0, 1)
        mask = torch.rand(n, batch * world, generator=g,
                          device=g.device) < keep
        mask = mask[:, rank * batch:(rank + 1) * batch]
        return (mask.float() / keep).to(device)

    def forward(self, x):
        s = self.scales(1, x.shape[0], x.device)
        if s is None:
            return x
        return x * s[0].view(-1, *([1] * (x.dim() - 1))).to(x.dtype)


class Dropout(nn.Module):
    """Element-wise dropout drawn from an explicit generator (flax's
    Dropout: keep with 1 - rate, kept values scaled by 1 / (1 - rate));
    the identity in eval mode. Training at a rate above 0 without a
    generator (``set_generator``) raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        g = self.generator
        if g is None:
            raise RuntimeError("Dropout in training needs a torch.Generator "
                               "(core.layers.set_generator)")
        keep = torch.rand(x.shape, generator=g, device=g.device).to(
            x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_generator(model: nn.Module, generator: torch.Generator,
                  shard: Optional[Tuple[int, int]] = None) -> None:
    """Draw every DropPath's and Dropout's masks in ``model`` from
    ``generator``; DropPath over the global batch of a data-parallel run
    with ``shard`` (rank, world)."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator, m.shard = generator, shard
        elif isinstance(m, Dropout):
            m.generator = generator


class Mlp(nn.Module):
    """Linear -> (optional DWConv) -> GELU -> Linear, children "0" and "3"
    (and "1" for the dwconv). The same instance serves the image and the
    meta tokens of a block."""

    def __init__(self, dim: int, hidden_dim: int, use_dwconv: bool = False):
        super().__init__()
        self.add_module("0", nn.Linear(dim, hidden_dim))
        if use_dwconv:
            self.add_module("1", DWConv(hidden_dim))
        self.add_module("3", nn.Linear(hidden_dim, dim))
        self.use_dwconv = use_dwconv

    @property
    def fc1(self) -> nn.Linear:
        return self._modules["0"]

    @property
    def fc2(self) -> nn.Linear:
        return self._modules["3"]

    def forward(self, x, hw: Optional[tuple] = None):
        x = self.fc1(x)
        if self.use_dwconv:
            x = self._modules["1"](x, hw)
        return self.fc2(F.gelu(x))


class MetaTokenDownsample(nn.Sequential):
    """Meta-token channel projection between stages: Linear(4 d_in) -> LN ->
    GELU -> Linear(d_out) -> LN. Its LayerNorms use eps 1e-5, unlike the
    blocks' 1e-6."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(
            nn.Linear(d_in, 4 * d_in),
            nn.LayerNorm(4 * d_in, eps=1e-5),
            nn.GELU(),
            nn.Linear(4 * d_in, d_out),
            nn.LayerNorm(d_out, eps=1e-5))
