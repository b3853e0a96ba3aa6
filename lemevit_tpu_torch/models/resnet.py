"""ResNet feature-pyramid backbone: counterpart of
lemevit_tpu/models/resnet.py (the change-detection vertical's ResNet
choice). NHWC in and out; ``features_only`` returns the stride-4/8/16/32
maps [C2, C3, C4, C5], as LeMeViT's pyramid. Module names are the JAX
package's (``stem_conv``, ``stem_bn``, ``layer{i}_{j}.conv1`` /
``bn1`` / ... / ``down_conv`` / ``down_bn``, ``fc``), so
``models/convert.py::from_jax_resnet`` moves its variables in. Bias-free
convolutions (torch's default init), BatchNorm with eps 1e-5 and flax's
momentum 0.9.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import BatchNorm, nhwc_conv


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm(features, eps=1e-5)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features, eps=1e-5)
        self.has_down = stride != 1 or cin != features
        if self.has_down:
            self.down_conv = _conv(cin, features, 1, stride)
            self.down_bn = BatchNorm(features, eps=1e-5)

    def _forward(self, x):  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(y + idt)

    def forward(self, x):
        return nhwc_conv(self._forward, x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = BatchNorm(features, eps=1e-5)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm(features, eps=1e-5)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = BatchNorm(out, eps=1e-5)
        self.has_down = stride != 1 or cin != out
        if self.has_down:
            self.down_conv = _conv(cin, out, 1, stride)
            self.down_bn = BatchNorm(out, eps=1e-5)

    def _forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(y + idt)

    def forward(self, x):
        return nhwc_conv(self._forward, x)


class ResNet(nn.Module):
    """features_only ResNet: a 7x7 s2 stem, 3x3 s2 max pool, four stages;
    returns [C2, C3, C4, C5] NHWC maps, or float32 logits (B, num_classes)
    without ``features_only``."""

    def __init__(self, block=BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64, features_only: bool = True,
                 num_classes: int = 0, in_chans: int = 3):
        super().__init__()
        self.layers = tuple(layers)
        self.features_only = features_only
        self.stem_conv = _conv(in_chans, width, 7, 2)
        self.stem_bn = BatchNorm(width, eps=1e-5)
        cin = width
        self.out_channels = []
        for i, n in enumerate(self.layers):
            features = width * 2 ** i
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_{j}",
                                block(cin, features, stride))
                cin = features * block.expansion
            self.out_channels.append(cin)
        if not features_only:
            self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = nhwc_conv(lambda t: F.max_pool2d(
            F.relu(self.stem_bn(self.stem_conv(t))), 3, 2, 1),
            x.to(self.stem_conv.weight.dtype))
        feats = []
        for i, n in enumerate(self.layers):
            for j in range(n):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            feats.append(x)
        if self.features_only:
            return feats
        x = x.mean(dim=(1, 2)).float()
        return F.linear(x, self.fc.weight.float(), self.fc.bias.float())


def resnet18(**kw) -> ResNet:
    return ResNet(block=BasicBlock, layers=(2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(block=BasicBlock, layers=(3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), **kw)
