"""BIT change detection (Bitemporal Image Transformer): counterpart of
lemevit_tpu/tasks/change_detection.py.

A Siamese backbone (LeMeViT, ResNet or Swin, shared weights) is called
once per image; its ``feature_index`` map (stride 16) is upsampled 2x and
goes to the head: a 3x3 ``conv_pred`` to ``dim`` channels, a semantic
tokeniser (a 1x1 conv to ``token_len`` maps, softmax over the pixels in
fp32, the pixels pooled by those weights), a transformer encoder over the
two images' tokens with ``pos_embed`` added to their concatenation, a
transformer decoder per image in which the pixels attend to their
image's tokens, then |f1 - f2|, a bilinear resize to the input size and
two 3x3 classifiers ``cls1`` / ``cls2``; the resize and the classifiers
run in fp32, outside autocast. Logits (B, H, W, num_classes) float32.

The backbone is called twice rather than on the concatenated pair, so its
BatchNorms normalise each image with that call's statistics and update
their running statistics twice, in order, as the JAX package's do. The
head's attention is plain matmuls (JAX's einsums, outside any Pallas
kernel); a LeMeViT backbone runs through the port's kernel dispatch and
stops after the map the head reads (its later stages are dead work, which
XLA drops from the JAX package's step; in training the next downsample
still runs for its BatchNorm statistics, which the JAX step updates).
Module names are the JAX package's (``backbone``, ``bit_head.conv_pred``,
``tokenizer``, ``enc{i}``, ``dec{i}`` with ``norm_q`` / ``norm_kv`` / q /
k / v / proj / ``norm_mlp`` / fc1 / fc2, ``pos_embed``, ``cls1``,
``cls2``), so ``models/convert.py::from_jax_cd`` moves its variables in.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import (init_weights, nhwc_conv,
                                           trunc_normal_)
from lemevit_tpu_torch.tasks.upernet import resize


def fp32_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """An NHWC convolution in fp32, outside autocast (JAX's
    ``dtype=jnp.float32`` heads)."""
    with torch.autocast(x.device.type, enabled=False):
        return nhwc_conv(lambda t: F.conv2d(
            t, conv.weight.float(), conv.bias.float(),
            padding=conv.padding), x.float())


class TransformerBlock(nn.Module):
    """Pre-norm attention + GELU MLP (LayerNorm eps 1e-6, flax's default);
    self-attention, or with ``cross`` the queries attend to the tokens
    given (normalised by their own ``norm_kv``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 cross: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.norm_q = nn.LayerNorm(dim, eps=1e-6)
        if cross:
            self.norm_kv = nn.LayerNorm(dim, eps=1e-6)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm_mlp = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, q_tokens, kv_tokens=None):
        qn = self.norm_q(q_tokens)
        kn = qn if kv_tokens is None else self.norm_kv(kv_tokens)
        h = self.num_heads

        def heads(t):
            b, n, c = t.shape
            return t.reshape(b, n, h, c // h).transpose(1, 2)

        q, k, v = heads(self.q(qn)), heads(self.k(kn)), heads(self.v(kn))
        d = q.shape[-1]
        attn = F.softmax((q @ k.transpose(-1, -2)).float() * d ** -0.5,
                         dim=-1)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).flatten(2)
        x = q_tokens + self.proj(out)
        return x + self.fc2(F.gelu(self.fc1(self.norm_mlp(x))))


class BITHead(nn.Module):
    """The bitemporal image transformer on a pair of NHWC feature maps of
    ``in_ch`` channels."""

    def __init__(self, in_ch: int, dim: int = 32, token_len: int = 4,
                 enc_depth: int = 1, dec_depth: int = 8, num_heads: int = 8,
                 num_classes: int = 2):
        super().__init__()
        self.token_len = token_len
        self.conv_pred = nn.Conv2d(in_ch, dim, 3, padding=1)
        self.tokenizer = nn.Conv2d(dim, token_len, 1)
        for i in range(enc_depth):
            self.add_module(f"enc{i}", TransformerBlock(dim, num_heads))
        for i in range(dec_depth):
            self.add_module(f"dec{i}",
                            TransformerBlock(dim, num_heads, cross=True))
        self.enc_depth, self.dec_depth = enc_depth, dec_depth
        self.pos_embed = nn.Parameter(torch.zeros(1, 2 * token_len, dim))
        self.cls1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.cls2 = nn.Conv2d(dim, num_classes, 3, padding=1)

    def _tokenize(self, f):
        """Semantic tokens (B, L, C): the pixels pooled by softmax weights
        over the pixels, in fp32."""
        b, h, w, c = f.shape
        attn = nhwc_conv(self.tokenizer, f).reshape(b, h * w, self.token_len)
        attn = F.softmax(attn.float(), dim=1)
        return attn.to(f.dtype).transpose(1, 2) @ f.reshape(b, h * w, c)

    def _refine(self, f, tokens):
        b, h, w, c = f.shape
        pix = f.reshape(b, h * w, c)
        for i in range(self.dec_depth):
            pix = getattr(self, f"dec{i}")(pix, tokens)
        return pix.reshape(b, h, w, c)

    def forward(self, f1, f2, out_size: Tuple[int, int]):
        f1 = nhwc_conv(self.conv_pred, f1)
        f2 = nhwc_conv(self.conv_pred, f2)
        tokens = torch.cat([self._tokenize(f1), self._tokenize(f2)], dim=1)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for i in range(self.enc_depth):
            tokens = getattr(self, f"enc{i}")(tokens)
        t1, t2 = tokens.chunk(2, dim=1)
        diff = (self._refine(f1, t1) - self._refine(f2, t2)).abs()
        with torch.autocast(diff.device.type, enabled=False):
            diff = resize(diff.float(), out_size)
        return fp32_conv(self.cls2, F.relu(fp32_conv(self.cls1, diff)))


def feature_channels(backbone: nn.Module, index: int) -> int:
    """The channels of map ``index`` of a features_only backbone."""
    if hasattr(backbone, "out_indices"):  # LeMeViT
        return backbone.embed_dim[backbone.out_indices[index]]
    return backbone.out_channels[index]


class BITChangeDetector(nn.Module):
    """Siamese backbone + BIT head: (img1, img2) NHWC -> per-pixel change
    logits (B, H, W, num_classes) float32, from the ``feature_index`` map
    of the backbone (the stride-16 map by default, as the reference)."""

    def __init__(self, backbone: nn.Module, feature_index: int = 2,
                 dim: int = 32, token_len: int = 4, enc_depth: int = 1,
                 dec_depth: int = 8, num_classes: int = 2):
        super().__init__()
        if hasattr(backbone, "out_indices"):
            # LeMeViT: stop after the map the head reads
            backbone.out_indices = backbone.out_indices[:feature_index + 1]
        self.backbone = backbone
        self.feature_index = feature_index
        self.bit_head = BITHead(feature_channels(backbone, feature_index),
                                dim, token_len, enc_depth, dec_depth,
                                num_classes=num_classes)

    def forward(self, img1, img2):
        h, w = img1.shape[1:3]
        f1 = self.backbone(img1)[self.feature_index]
        f2 = self.backbone(img2)[self.feature_index]
        f1 = resize(f1, (f1.shape[1] * 2, f1.shape[2] * 2))
        f2 = resize(f2, (f2.shape[1] * 2, f2.shape[2] * 2))
        return self.bit_head(f1, f2, (h, w))


def init_head(head: nn.Module, generator: torch.Generator) -> None:
    """Initialise a head from ``generator`` with the port's
    distributions (core/layers.init_weights; ``pos_embed``
    trunc-normal(0.02))."""
    init_weights(head, generator)
    for name, p in head.named_parameters():
        if name.endswith("pos_embed"):
            trunc_normal_(p, generator=generator)


def create_bit(backbone: str, *, device=None, seed: int = 0,
               dtype: torch.dtype = torch.float32,
               backbone_kwargs: Optional[dict] = None,
               **kwargs) -> BITChangeDetector:
    """BIT over a registry backbone, features_only, from ``seed`` (the
    backbone's weights are those of create_model(backbone, seed=seed))."""
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    bb = create_model(backbone, device="cpu", seed=seed, features_only=True,
                      **(backbone_kwargs or {}))
    model = BITChangeDetector(bb, **kwargs)
    init_head(model.bit_head, torch.Generator().manual_seed(seed + 1))
    return model.to(device=resolve_device(device), dtype=dtype)
