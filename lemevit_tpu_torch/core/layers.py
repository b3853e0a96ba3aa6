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
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    eval mode is torch's own."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = x32.var(dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


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
    reproducible; training at a rate above 0 without one raises."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

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
        mask = torch.rand(n, batch, generator=g, device=g.device) < keep
        return (mask.float() / keep).to(device)

    def forward(self, x):
        s = self.scales(1, x.shape[0], x.device)
        if s is None:
            return x
        return x * s[0].view(-1, *([1] * (x.dim() - 1))).to(x.dtype)


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
