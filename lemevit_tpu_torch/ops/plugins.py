"""Plugin layers: ContextBlock (GCNet), NonLocal2D, GeneralizedAttention,
the NAS-FPN merge cells and a plugin registry; counterpart of
lemevit_tpu/ops/plugins.py (the reference's mmdet context_block,
non_local, generalized_attention, merge_cells and plugin modules).

NHWC in and out; the 1x1 and 3x3 convolutions run on channels-last views
(core/layers.nhwc_conv). Submodule names are the JAX package's
(``conv_mask``, ``channel_add_fc1``, ``g``, ``theta``, ``query``,
``pos_proj``, ``conv``, ``bn`` ...), so models/convert.py::
from_jax_plugin moves their variables in. flax infers a layer's input
width from its first input; torch needs it at construction, so the NAS-FPN
cells take ``in_channels`` (None: out_channels, the width NAS-FPN merges
at). Parameters are drawn as flax's defaults (LeCun-normal kernels, zero
biases, norms one and zero; NonLocal2D's ``conv_out`` zero, so the block
is the identity at init) from ``generator`` (None: a generator seeded 0).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import BatchNorm, nhwc_conv
from lemevit_tpu_torch.tasks.upernet import resize

PLUGIN_LAYERS: Dict[str, Type[nn.Module]] = {}


def register_plugin(name: str) -> Callable:
    def deco(cls):
        PLUGIN_LAYERS[name] = cls
        return cls
    return deco


def build_plugin_layer(cfg: Dict, **kwargs) -> Tuple[str, nn.Module]:
    """mm-style: build_plugin_layer(dict(type='ContextBlock', ...))."""
    cfg = dict(cfg)
    name = cfg.pop("type")
    if name not in PLUGIN_LAYERS:
        raise KeyError(f"unknown plugin {name!r}; known: "
                       f"{sorted(PLUGIN_LAYERS)}")
    return name.lower(), PLUGIN_LAYERS[name](**cfg, **kwargs)


def flax_init_(module: nn.Module, generator: Optional[torch.Generator]
               ) -> None:
    """flax's default initialisers on every conv and linear of ``module``:
    the kernel LeCun-normal (variance 1 / fan_in, truncated at 2 std and
    rescaled), the bias zero; norms one and zero."""
    g = generator if generator is not None else torch.Generator(
        ).manual_seed(0)
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


def _conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)


@register_plugin("ContextBlock")
class ContextBlock(nn.Module):
    """GCNet global-context block: softmax spatial pooling, a channel
    transform, add / mul fusion."""

    def __init__(self, in_channels: int, ratio: float = 1.0 / 16.0,
                 pooling_type: str = "att",
                 fusion_types: Sequence[str] = ("channel_add",),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pooling_type = pooling_type
        self.fusion_types = tuple(fusion_types)
        planes = max(int(in_channels * ratio), 1)
        if pooling_type == "att":
            self.conv_mask = _conv1x1(in_channels, 1)
        for name in ("channel_mul", "channel_add"):
            if name in self.fusion_types:
                self.add_module(f"{name}_fc1", _conv1x1(in_channels, planes))
                self.add_module(f"{name}_ln", nn.LayerNorm(planes, eps=1e-6))
                self.add_module(f"{name}_fc2", _conv1x1(planes, in_channels))
        flax_init_(self, generator)

    def _transform(self, name: str, ctx: torch.Tensor) -> torch.Tensor:
        t = nhwc_conv(getattr(self, f"{name}_fc1"), ctx)
        t = F.relu(getattr(self, f"{name}_ln")(t))
        return nhwc_conv(getattr(self, f"{name}_fc2"), t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if self.pooling_type == "att":
            attn = nhwc_conv(self.conv_mask, x).reshape(b, h * w, 1)
            attn = torch.softmax(attn.float(), dim=1).to(x.dtype)
            ctx = torch.einsum("bnk,bnc->bc", attn, x.reshape(b, h * w, c))
        else:
            ctx = x.mean(dim=(1, 2))
        ctx = ctx[:, None, None, :]
        out = x
        if "channel_mul" in self.fusion_types:
            out = out * torch.sigmoid(self._transform("channel_mul", ctx))
        if "channel_add" in self.fusion_types:
            out = out + self._transform("channel_add", ctx)
        return out


@register_plugin("NonLocal2D")
class NonLocal2D(nn.Module):
    """Non-local block (embedded gaussian / dot product / gaussian)."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 mode: str = "embedded_gaussian", sub_sample: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mode = mode
        self.sub_sample = sub_sample
        inter = max(in_channels // reduction, 1)
        self.g = _conv1x1(in_channels, inter)
        if mode != "gaussian":
            self.theta = _conv1x1(in_channels, inter)
            self.phi = _conv1x1(in_channels, inter)
        self.conv_out = _conv1x1(inter, in_channels)
        flax_init_(self, generator)
        nn.init.zeros_(self.conv_out.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = nhwc_conv(self.g, x)
        inter = g.shape[-1]
        if self.mode == "gaussian":
            theta, phi = x, x
        else:
            theta, phi = nhwc_conv(self.theta, x), nhwc_conv(self.phi, x)
        if self.sub_sample:
            pool = lambda t: F.max_pool2d(t, 2, 2)  # noqa: E731
            phi, g = nhwc_conv(pool, phi), nhwc_conv(pool, g)
        m = phi.shape[1] * phi.shape[2]
        theta = theta.reshape(b, h * w, -1)
        phi = phi.reshape(b, m, -1)
        g = g.reshape(b, m, inter)
        logits = torch.einsum("bnc,bmc->bnm", theta.float(), phi.float())
        if self.mode in ("embedded_gaussian", "gaussian"):
            attn = torch.softmax(logits, dim=-1)
        else:  # dot_product
            attn = logits / m
        y = torch.einsum("bnm,bmc->bnc", attn.to(g.dtype), g)
        y = nhwc_conv(self.conv_out, y.reshape(b, h, w, inter))
        return x + y


@register_plugin("GeneralizedAttention")
class GeneralizedAttention(nn.Module):
    """Generalized attention: the content-content and content-position
    terms (the reference's '1111' configuration) over NHWC maps, with a
    projected sinusoidal embedding of the key positions."""

    def __init__(self, in_channels: int, num_heads: int = 9,
                 spatial_range: int = -1, kv_stride: int = 2,
                 q_stride: int = 1, position_embedding_dim: int = -1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.kv_stride, self.q_stride = kv_stride, q_stride
        qk_dim = max(in_channels // num_heads, 1) * num_heads
        self.qk_dim = qk_dim
        self.pos_dim = (position_embedding_dim
                        if position_embedding_dim > 0 else qk_dim)
        self.query = _conv1x1(in_channels, qk_dim)
        self.key = _conv1x1(in_channels, qk_dim)
        self.value = _conv1x1(in_channels, qk_dim)
        self.pos_proj = nn.Linear(4 * (self.pos_dim // 4), qk_dim)
        self.proj = _conv1x1(qk_dim, in_channels)
        flax_init_(self, generator)

    def _position_embedding(self, kh: int, kw: int, device) -> torch.Tensor:
        """(kh kw, 4 (pos_dim // 4)): sin and cos of the normalised key
        row and column at pos_dim // 4 frequencies."""
        ry = torch.arange(kh, device=device)[:, None] / max(kh - 1, 1)
        rx = torch.arange(kw, device=device)[None, :] / max(kw - 1, 1)
        pos = torch.stack(torch.broadcast_tensors(ry, rx), -1).reshape(
            kh * kw, 2)
        nf = self.pos_dim // 4
        freq = torch.exp(torch.arange(nf, device=device)
                         * (-math.log(100.0) / max(nf, 1)))
        ang = pos[:, :, None] * freq[None, None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], -1).reshape(
            kh * kw, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads, qk_dim = self.num_heads, self.qk_dim
        q_map = x[:, ::self.q_stride, ::self.q_stride]
        kv_map = x[:, ::self.kv_stride, ::self.kv_stride]
        qh, qw = q_map.shape[1:3]
        kh, kw = kv_map.shape[1:3]
        d = qk_dim // heads
        q = nhwc_conv(self.query, q_map).reshape(b, qh * qw, heads, d)
        k = nhwc_conv(self.key, kv_map).reshape(b, kh * kw, heads, d)
        v = nhwc_conv(self.value, kv_map).reshape(b, kh * kw, heads, d)
        pe = self.pos_proj(self._position_embedding(kh, kw, x.device).to(
            x.dtype)).reshape(kh * kw, heads, d)
        logits = (torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
                  + torch.einsum("bnhd,mhd->bhnm", q.float(), pe.float()))
        attn = torch.softmax(logits * (d ** -0.5), dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v)
        out = nhwc_conv(self.proj, out.reshape(b, qh, qw, qk_dim))
        if (qh, qw) != (h, w):
            out = resize(out, (h, w))
        return x + out


class _MergeCell(nn.Module):
    """NAS-FPN merge cell: both inputs resized (nearest) to the output
    size, merged, ReLU, a bias-free 3x3 conv, BatchNorm (flax's momentum
    0.9, eps 1e-5; train mode in ``self.training``)."""

    def __init__(self, out_channels: int, in_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = out_channels if in_channels is None else in_channels
        self.conv = nn.Conv2d(cin, out_channels, 3, padding=1, bias=False)
        self.bn = BatchNorm(out_channels, eps=1e-5)
        flax_init_(self, generator)

    def _merge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        out_size = out_size or a.shape[1:3]
        a = resize(a, out_size, method="nearest")
        b = resize(b, out_size, method="nearest")
        x = F.relu(self._merge(a, b))
        return nhwc_conv(lambda t: self.bn(self.conv(t)), x)


class SumCell(_MergeCell):
    """NAS-FPN sum cell: a + b."""

    def _merge(self, a, b):
        return a + b


class GlobalPoolingCell(_MergeCell):
    """NAS-FPN GP cell: b gated by the sigmoid of a's global mean, plus
    a."""

    def _merge(self, a, b):
        return a + b * torch.sigmoid(a.mean(dim=(1, 2), keepdim=True))
