"""Swin Transformer feature-pyramid backbone: counterpart of
lemevit_tpu/models/swin.py (the change-detection vertical's Swin choice).
NHWC in and out; four stages of windowed self-attention (shifted windows
in every second block, with their mask), a learned relative position
bias per head, 2x2 patch merging (odd sides padded) between stages;
``features_only`` returns the stride-4/8/16/32 maps. A window larger than
the map shrinks to it (and then does not shift); a map that the window
does not divide is padded on its bottom and right. The JAX package sizes
each block's window, and with it its bias table, from the map it first
sees; the port sizes them from ``img_size`` (224 by default) and raises
where a later input's map would need another window. The 4x4 patch
embedding pads as flax's "SAME" does. Module names are the
JAX package's (``patch_embed``, ``norm0``, ``merge_norm{i}``,
``merge{i}``, ``stage{i}_block{j}.norm1`` / ``attn.qkv`` /
``attn.rel_pos_bias`` / ``attn.proj`` / ``norm2`` / ``mlp``), so
``models/convert.py::from_jax_swin`` moves its variables in. The
attention logits and softmax are fp32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import DropPath, Mlp, trunc_normal_


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B nW, ws ws, C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """The inverse of window_partition: (B nW, ws ws, C) -> (B, H, W, C)."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def rel_pos_index(ws: int) -> np.ndarray:
    """(ws ws, ws ws) index into the (2 ws - 1)^2 bias table of each pair
    of positions in a window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws ws, ws ws) additive mask of shifted-window attention: -1e9
    between positions that came from different regions of the map."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), ws).squeeze(-1)
    return torch.where(mw[:, None, :] != mw[:, :, None],
                       torch.tensor(-1e9), torch.tensor(0.0))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("rel_index", torch.from_numpy(
            rel_pos_index(window_size)), persistent=False)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        bw, n, c = x.shape
        h, d = self.num_heads, c // self.num_heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, h, d).unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * d ** -0.5
        bias = self.rel_pos_bias[self.rel_index.reshape(-1)].reshape(n, n, h)
        logits = logits + bias.permute(2, 0, 1)[None].float()
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(bw // nw, nw, h, n, n)
                      + mask.to(logits.device)[None, :, None]).reshape(
                          bw, h, n, n)
        attn = F.softmax(logits, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v)
        return self.proj(out.reshape(bw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, map_window: Optional[int] = None):
        super().__init__()
        # the model's window, and the one this block's map takes (its
        # bias table's size)
        self.window = window_size
        self.window_size = window_size if map_window is None else map_window
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, self.window_size)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        ws = min(self.window, h, w)
        shift = self.shift if ws < min(h, w) else 0
        if ws != self.window_size:
            raise ValueError(
                f"a {h}x{w} map needs a window of {ws}, this block was "
                f"built for {self.window_size} (SwinTransformer img_size)")
        shortcut = x
        x = self.norm1(x)
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = x.shape[1:3]
        mask = shift_mask(hp, wp, ws, shift) if shift else None
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws,
                           hp, wp)
        if pad_h or pad_w:
            x = x[:, :h, :w]
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(x)
        y = self.mlp(self.norm2(x).reshape(b, h * w, c)).reshape(b, h, w, c)
        return x + self.drop_path(y)


class SwinTransformer(nn.Module):
    """features_only Swin: returns [C2..C5] NHWC maps, or float32 logits
    (B, num_classes) without ``features_only``."""

    def __init__(self, depths: Sequence[int] = (2, 2, 6, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, drop_path_rate: float = 0.1,
                 features_only: bool = True, num_classes: int = 0,
                 in_chans: int = 3, img_size=224):
        super().__init__()
        hw = ((img_size, img_size) if isinstance(img_size, int)
              else tuple(img_size))
        hw = tuple(-(-v // 4) for v in hw)  # the patch embedding's map
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.features_only = features_only
        self.out_channels = list(self.dims)
        self.patch_embed = nn.Conv2d(in_chans, dims[0], 4, 4)
        self.norm0 = nn.LayerNorm(dims[0], eps=1e-5)
        dp = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        cur = 0
        for i, depth in enumerate(depths):
            if i > 0:
                self.add_module(f"merge_norm{i}",
                                nn.LayerNorm(4 * dims[i - 1], eps=1e-5))
                self.add_module(f"merge{i}", nn.Linear(4 * dims[i - 1],
                                                       dims[i], bias=False))
                hw = tuple(-(-v // 2) for v in hw)
            ws = min(window_size, *hw)
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dims[i], num_heads[i], window_size,
                    shift=0 if j % 2 == 0 else window_size // 2,
                    drop_path=dp[cur + j], map_window=ws))
            cur += depth
        if not features_only:
            self.norm = nn.LayerNorm(dims[-1], eps=1e-5)
            self.head = nn.Linear(dims[-1], num_classes)

    def forward(self, x):
        x = x.to(self.patch_embed.weight.dtype).permute(0, 3, 1, 2)
        pads = []
        for n in (x.shape[3], x.shape[2]):  # flax "SAME": (lo, hi) per side
            tot = max(-(-n // 4) * 4 - n, 0)
            pads += [tot // 2, tot - tot // 2]
        x = self.patch_embed(F.pad(x, pads) if any(pads) else x)
        x = self.norm0(x.permute(0, 2, 3, 1))
        feats = []
        for i, depth in enumerate(self.depths):
            if i > 0:  # patch merging: 2x2 neighbours side by side
                b, h, w, c = x.shape
                if h % 2 or w % 2:
                    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
                    b, h, w, c = x.shape
                x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                    0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
                x = getattr(self, f"merge{i}")(
                    getattr(self, f"merge_norm{i}")(x))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            feats.append(x)
        if self.features_only:
            return feats
        x = self.norm(x).mean(dim=(1, 2)).float()
        return F.linear(x, self.head.weight.float(), self.head.bias.float())


def init_swin(model: SwinTransformer, generator: torch.Generator) -> None:
    """The JAX package's initialisers: trunc-normal(0.02) kernels of the
    patch embedding, the Linear layers and the bias tables, zero biases,
    unit LayerNorms."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            trunc_normal_(mod.weight, generator=generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, WindowAttention):
            trunc_normal_(mod.rel_pos_bias, generator=generator)


def swin_tiny(**kw) -> SwinTransformer:
    return SwinTransformer(depths=(2, 2, 6, 2), dims=(96, 192, 384, 768),
                           num_heads=(3, 6, 12, 24), **kw)
