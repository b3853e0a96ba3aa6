"""SNUNet-style change detection: counterpart of lemevit_tpu/tasks/snunet.py.

  - SNUNetECAM: a Siamese nested UNet (UNet++) over the two images'
    encoder features, its four full-resolution outputs ensembled by
    channel attention (intra-group and overall), then a 1x1 classifier;
  - SiamNestedUNetConc: the same grid without attention, four 1x1
    classifiers and a final 1x1 over their concatenation; a 5-tuple of
    full-resolution logits (deep supervision);
  - SiamUnetDiff: a shared 4-stage encoder with dropout, decoded from the
    second image's pooled features through stride-2 transposed convs,
    concatenating |skip_1 - skip_2| at every scale; a 1-tuple.

NHWC in, float32 logits (B, H, W, num_classes) out; the classifiers and
SiamUnetDiff's last conv run in fp32 outside autocast. The nested grid's
node (i, j) convolves [A_i, B_i, nodes (i, 1..j-1), the upsampled node
(i + 1, j - 1)], where the first column upsamples the B branch's encoder
feature alone, so ``dec{i}_1.conv0`` takes filters[i] 2 + filters[i + 1]
channels. The upsampling is the JAX package's parameter-free bilinear
resize. Module names are the JAX package's, so
``models/convert.py::from_jax_cd`` moves its variables in.

SiamUnetDiff's dropout draws from the generator that
core.layers.set_generator gives it (cli.train_cd seeds one per step); it
cannot match the JAX package's ``fold_in(PRNGKey(17), step)`` draws bit
for bit.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import BatchNorm, Dropout, nhwc_conv
from lemevit_tpu_torch.tasks.change_detection import fp32_conv
from lemevit_tpu_torch.tasks.upernet import resize


def _max_pool(x):
    return nhwc_conv(lambda t: F.max_pool2d(t, 2, 2), x)


class ConvBlock(nn.Module):
    """Two (3x3 bias-free conv, BatchNorm, ReLU)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        for i in range(2):
            self.add_module(f"conv{i}", nn.Conv2d(
                cin if i == 0 else features, features, 3, padding=1,
                bias=False))
            self.add_module(f"bn{i}", BatchNorm(features, eps=1e-5))

    def forward(self, x):
        def f(t):
            for i in range(2):
                t = F.relu(getattr(self, f"bn{i}")(
                    getattr(self, f"conv{i}")(t)))
            return t
        return nhwc_conv(f, x)


class ChannelAttention(nn.Module):
    """ECAM gate: sigmoid(mlp(avg pool) + mlp(max pool)), (B, 1, 1, C)."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.fc1 = nn.Conv2d(channels, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, channels, 1)

    def forward(self, x):
        def mlp(t):
            return nhwc_conv(lambda u: self.fc2(F.relu(self.fc1(u))), t)
        return torch.sigmoid(mlp(x.mean(dim=(1, 2), keepdim=True))
                             + mlp(x.amax(dim=(1, 2), keepdim=True)))


def _encoders(module: nn.Module, chans: List[int], in_chans: int) -> None:
    for i, ch in enumerate(chans):
        module.add_module(f"enc{i}", ConvBlock(
            in_chans if i == 0 else chans[i - 1], ch))


def _siamese_encode(module, n, img1, img2):
    """The shared encoder on both images, max-pooled between stages; the
    per-stage (pre-pool) features of each."""
    feats1, feats2 = [], []
    x1, x2 = img1, img2
    for i in range(n):
        if i > 0:
            x1, x2 = _max_pool(x1), _max_pool(x2)
        blk = getattr(module, f"enc{i}")
        x1, x2 = blk(x1), blk(x2)
        feats1.append(x1)
        feats2.append(x2)
    return feats1, feats2


def _grid_decoders(module: nn.Module, chans: List[int]) -> None:
    depth = len(chans)
    for j in range(1, depth):
        for i in range(depth - j):
            cin = 2 * chans[i] + (j - 1) * chans[i] + chans[i + 1]
            module.add_module(f"dec{i}_{j}", ConvBlock(cin, chans[i]))


def _nested_grid(module, feats1, feats2, depth):
    grid = {(i, 0): torch.cat([feats1[i], feats2[i]], dim=-1)
            for i in range(depth)}
    for j in range(1, depth):
        for i in range(depth - j):
            src = feats2[i + 1] if j == 1 else grid[(i + 1, j - 1)]
            ups = resize(src, grid[(i, 0)].shape[1:3])
            cat = torch.cat([grid[(i, k)] for k in range(j)] + [ups], dim=-1)
            grid[(i, j)] = getattr(module, f"dec{i}_{j}")(cat)
    return grid


class SNUNetECAM(nn.Module):
    def __init__(self, base_channels: int = 32, num_classes: int = 2,
                 in_chans: int = 3):
        super().__init__()
        c = base_channels
        self.chans = [c, c * 2, c * 4, c * 8, c * 16]
        _encoders(self, self.chans, in_chans)
        _grid_decoders(self, self.chans)
        self.ca_intra = ChannelAttention(c, ratio=4)
        self.ca_all = ChannelAttention(4 * c)
        self.head = nn.Conv2d(4 * c, num_classes, 1)

    def forward(self, img1, img2):
        feats1, feats2 = _siamese_encode(self, len(self.chans), img1, img2)
        grid = _nested_grid(self, feats1, feats2, len(self.chans))
        outs = [grid[(0, j)] for j in range(1, 5)]
        stacked = torch.cat(outs, dim=-1)
        intra = sum(outs) / 4.0
        gated = (stacked * self.ca_all(stacked)
                 + self.ca_intra(intra).repeat(1, 1, 1, 4) * stacked)
        return fp32_conv(self.head, gated)


class SiamNestedUNetConc(nn.Module):
    def __init__(self, base_channels: int = 32, num_classes: int = 2,
                 in_chans: int = 3):
        super().__init__()
        c = base_channels
        self.chans = [c, c * 2, c * 4, c * 8, c * 16]
        _encoders(self, self.chans, in_chans)
        _grid_decoders(self, self.chans)
        for j in range(1, 5):
            self.add_module(f"final{j}", nn.Conv2d(c, num_classes, 1))
        self.conv_final = nn.Conv2d(4 * num_classes, num_classes, 1)

    def forward(self, img1, img2):
        feats1, feats2 = _siamese_encode(self, len(self.chans), img1, img2)
        grid = _nested_grid(self, feats1, feats2, len(self.chans))
        heads = [fp32_conv(getattr(self, f"final{j}"), grid[(0, j)])
                 for j in range(1, 5)]
        return (*heads, fp32_conv(self.conv_final, torch.cat(heads, -1)))


def conv_transpose_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax's ConvTranspose (a k x k kernel, stride 2, "SAME" padding, the
    kernel not flipped) on NCHW ``x``, with ``conv``'s weight and bias
    (``conv`` unpadded): the input dilated by 2, padded as
    lax.conv_transpose pads "SAME" (k - 1 + s - 1 in all, before it
    k - 1 where the stride exceeds k - 1, else half of it rounded up:
    (2, 1) at k = 3, (1, 1) at k = 2) and correlated with the kernel.
    Output 2H x 2W."""
    b, c, h, w = x.shape
    k, s = conv.kernel_size[0], 2
    total = k + s - 2
    before = k - 1 if s > k - 1 else -(-total // 2)
    z = x.new_zeros(b, c, 2 * h - 1, 2 * w - 1)
    z[:, :, ::2, ::2] = x
    pad = (before, total - before)
    return conv(F.pad(z, pad + pad))


class SiamUnetDiff(nn.Module):
    N_CONVS = (2, 2, 3, 3)

    def __init__(self, base_channels: int = 16, num_classes: int = 2,
                 in_chans: int = 3):
        super().__init__()
        c = base_channels
        self.chans = chans = [c, c * 2, c * 4, c * 8]
        cin = in_chans
        for i, (ch, nc) in enumerate(zip(chans, self.N_CONVS)):
            for k in range(nc):
                self.add_module(f"enc{i}_conv{k}", nn.Conv2d(
                    cin, ch, 3, padding=1))
                self.add_module(f"enc{i}_bn{k}", BatchNorm(ch, eps=1e-5))
                self.add_module(f"enc{i}_do{k}", Dropout(0.2))
                cin = ch
        self.dec_convs = [[chans[3], chans[3], chans[2]],
                          [chans[2], chans[2], chans[1]],
                          [chans[1], chans[0]],
                          [chans[0], num_classes]]
        x_ch = chans[3]
        for d, outs in enumerate(self.dec_convs):
            lvl = 3 - d
            self.add_module(f"up{lvl}", nn.Conv2d(x_ch, x_ch, 3))
            cin = x_ch + chans[lvl]
            for i, ch in enumerate(outs):
                self.add_module(f"dec{lvl}_{i}", nn.Conv2d(cin, ch, 3,
                                                           padding=1))
                if not (d == 3 and i == len(outs) - 1):
                    self.add_module(f"dbn{lvl}_{i}", BatchNorm(ch, eps=1e-5))
                    self.add_module(f"ddo{lvl}_{i}", Dropout(0.2))
                cin = ch
            x_ch = cin

    def _encode(self, x):
        skips = []
        for i, nc in enumerate(self.N_CONVS):
            def stage(t, i=i, nc=nc):
                for k in range(nc):
                    t = F.relu(getattr(self, f"enc{i}_bn{k}")(
                        getattr(self, f"enc{i}_conv{k}")(t)))
                    t = getattr(self, f"enc{i}_do{k}")(t)
                return t
            x = nhwc_conv(stage, x)
            skips.append(x)
            x = _max_pool(x)
        return x, skips

    def forward(self, img1, img2):
        _, skips1 = self._encode(img1)
        x, skips2 = self._encode(img2)  # decoded from image 2's pool4
        for d, outs in enumerate(self.dec_convs):
            lvl = 3 - d
            x = nhwc_conv(lambda t: conv_transpose_same(
                getattr(self, f"up{lvl}"), t), x)
            skip = (skips1[lvl].float() - skips2[lvl].float()).abs().to(
                skips1[lvl].dtype)
            x = torch.cat([resize(x, skip.shape[1:3]), skip], dim=-1)
            for i in range(len(outs)):
                conv = getattr(self, f"dec{lvl}_{i}")
                if d == 3 and i == len(outs) - 1:
                    return (fp32_conv(conv, x),)
                x = nhwc_conv(lambda t: getattr(self, f"ddo{lvl}_{i}")(F.relu(
                    getattr(self, f"dbn{lvl}_{i}")(conv(t)))), x)
