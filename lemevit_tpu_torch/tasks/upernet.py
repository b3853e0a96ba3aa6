"""UperNet semantic segmentation and slide inference: counterpart of
lemevit_tpu/tasks/upernet.py (mmseg's upernet_lemevit configs: the LeMeViT
feature pyramid into a UPerHead with PPM pool scales 1/2/3/6 and 512
channels, an auxiliary FCNHead on the stage-3 feature, slide inference
with 512^2 crops at stride 384).

NHWC at every boundary, as the backbone; the convolutions run on
channels-last NCHW views (core/layers.nhwc_conv). Module names are the
JAX package's (``decode_head.ppm.pool{i}``, ``bottleneck``,
``lateral{i}``, ``fpn{i}``, ``fuse``, ``seg``; ``aux_head.conv{i}``,
``seg``), so ``models/convert.py::from_jax_upernet`` moves its variables
in; mmseg's checkpoint names are not mapped. The final 1x1 ``seg``
convolutions run in fp32 outside autocast, as the JAX package's
``dtype=jnp.float32`` heads do.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import BatchNorm, init_weights, nhwc_conv


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``size`` = (h, w), as
    ``jax.image.resize(..., "bilinear")``: half-pixel centres and, where a
    side shrinks, an antialiasing (triangle) filter widened by the scale
    (in fp32: PyTorch's CPU filter takes no bf16); the identity at the
    same size."""
    h, w = x.shape[1:3]
    size = tuple(size)
    if (h, w) == size:
        return x
    shrink = size[0] < h or size[1] < w
    t = x.permute(0, 3, 1, 2)
    return F.interpolate(t.float() if shrink else t, size=size,
                         mode="bilinear", align_corners=False,
                         antialias=shrink).to(x.dtype).permute(0, 2, 3, 1)


def _pool_matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) averaging weights of torch's adaptive pool: output bin
    i averages inputs [floor(i n_in / n_out), ceil((i + 1) n_in / n_out))."""
    i = torch.arange(n_out)[:, None]
    j = torch.arange(n_in)[None, :]
    lo = i * n_in // n_out
    hi = -(-(i + 1) * n_in // n_out)
    m = ((j >= lo) & (j < hi)).to(like.dtype)
    return (m / m.sum(dim=1, keepdim=True).clamp(min=1)).to(like.device)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """torch-style adaptive average pool of NHWC ``x`` to ``out_hw``, also
    where the output is larger than the input, as two small averaging
    products (the JAX package's form)."""
    mh = _pool_matrix(x.shape[1], out_hw[0], x)
    mw = _pool_matrix(x.shape[2], out_hw[1], x)
    out = torch.einsum("ph,bhwc->bpwc", mh, x)
    return torch.einsum("qw,bpwc->bpqc", mw, out)


def _seg_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 classifier in fp32, outside autocast."""
    with torch.autocast(x.device.type, enabled=False):
        return nhwc_conv(lambda t: F.conv2d(t, conv.weight.float(),
                                            conv.bias.float()), x.float())


class ConvModule(nn.Module):
    """Bias-free conv, BatchNorm (eps 1e-5, flax's momentum 0.9), ReLU;
    NHWC in and out."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size,
                              padding=kernel_size // 2, bias=False)
        self.bn = BatchNorm(out_ch, eps=1e-5)

    def forward(self, x):
        return nhwc_conv(lambda t: F.relu(self.bn(self.conv(t))), x)


class PPM(nn.Module):
    """Pyramid pooling: adaptive-average-pool to each scale, 1x1
    ConvModule, resize back."""

    def __init__(self, in_ch: int, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 channels: int = 512):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for i in range(len(self.pool_scales)):
            self.add_module(f"pool{i}", ConvModule(in_ch, channels, 1))

    def forward(self, x):
        h, w = x.shape[1:3]
        return [resize(getattr(self, f"pool{i}")(
                    adaptive_avg_pool(x, (s, s))), (h, w))
                for i, s in enumerate(self.pool_scales)]


class UPerHead(nn.Module):
    """FPN-style fusion of the feature pyramid (channels ``in_channels``)
    with PPM on its top level; returns fp32 class logits at the finest
    level's resolution."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        in_channels = tuple(in_channels)
        self.levels = len(in_channels)
        top = in_channels[-1]
        self.ppm = PPM(top, pool_scales, channels)
        self.bottleneck = ConvModule(top + len(pool_scales) * channels,
                                     channels, 3)
        for i, ch in enumerate(in_channels[:-1]):
            self.add_module(f"lateral{i}", ConvModule(ch, channels, 1))
            self.add_module(f"fpn{i}", ConvModule(channels, channels, 3))
        self.fuse = ConvModule(self.levels * channels, channels, 3)
        self.seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        top = feats[-1]
        top = self.bottleneck(torch.cat([top] + self.ppm(top), dim=-1))
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats[:-1])] + [top]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], laterals[i - 1].shape[1:3])
        outs = [getattr(self, f"fpn{i}")(laterals[i])
                for i in range(len(laterals) - 1)] + [laterals[-1]]
        hw = outs[0].shape[1:3]
        fused = self.fuse(torch.cat([resize(f, hw) for f in outs], dim=-1))
        return _seg_conv(self.seg, fused)


class FCNHead(nn.Module):
    """Auxiliary FCN head on one pyramid level: ``num_convs`` 3x3
    ConvModules and an fp32 1x1 classifier."""

    def __init__(self, in_ch: int, num_classes: int, channels: int = 256,
                 num_convs: int = 1):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvModule(
                in_ch if i == 0 else channels, channels, 3))
        self.seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        return _seg_conv(self.seg, x)


class UperNet(nn.Module):
    """EncoderDecoder: a ``features_only`` LeMeViT -> UPerHead, and the
    auxiliary FCNHead on feature ``aux_index`` (stage 3). Input NHWC
    images; output fp32 logits (B, H, W, num_classes) at the input's size,
    and with ``with_aux`` the auxiliary logits too."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 channels: int = 512, aux_index: int = 2,
                 aux_channels: int = 256):
        super().__init__()
        if not backbone.features_only:
            raise ValueError("UperNet needs a features_only backbone")
        dims = [backbone.embed_dim[i] for i in backbone.out_indices]
        self.backbone = backbone
        self.num_classes = num_classes
        self.aux_index = aux_index
        self.decode_head = UPerHead(dims, num_classes, channels)
        self.aux_head = FCNHead(dims[aux_index], num_classes, aux_channels)

    def forward(self, x, with_aux: bool = False):
        hw = x.shape[1:3]
        feats = self.backbone(x)
        logits = resize(self.decode_head(feats), hw)
        if with_aux:
            return logits, resize(self.aux_head(feats[self.aux_index]), hw)
        return logits


def create_upernet(backbone: str, num_classes: int, *, channels: int = 512,
                   device: Optional[object] = None, seed: int = 0,
                   train_cpe_in_kernel: bool = False) -> UperNet:
    """UperNet on the registry's ``backbone`` (features_only), the backbone
    initialised as ``create_model`` does from ``seed`` and the heads from
    ``seed + 1`` (convs torch's default, BatchNorm one and zero), moved to
    ``device`` (CUDA by default; see models.registry.resolve_device).
    ``train_cpe_in_kernel``: the backbone's training kernels apply the 3x3
    CPEs (``create_model``'s switch; JAX's ``PB_TRAIN_CPE=fused``)."""
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    dev = resolve_device(device)
    bb = create_model(backbone, device="cpu", seed=seed, features_only=True,
                      train_cpe_in_kernel=train_cpe_in_kernel)
    model = UperNet(bb, num_classes, channels)
    g = torch.Generator().manual_seed(seed + 1)
    init_weights(model.decode_head, g)
    init_weights(model.aux_head, g)
    return model.to(dev)


def slide_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, num_classes: int, crop_size: int = 512,
                    stride: int = 384) -> torch.Tensor:
    """Sliding-window inference (mmseg's test mode 'slide'): windows of
    ``crop_size`` every ``stride`` pixels, plus a last row and column flush
    with the far edges; each pixel's fp32 logits averaged over the windows
    that cover it. apply_fn: NHWC crop -> (B, ch, cw, num_classes)."""
    b, h, w, _ = x.shape
    hs = list(range(0, max(h - crop_size, 0) + 1, stride))
    ws = list(range(0, max(w - crop_size, 0) + 1, stride))
    if hs[-1] + crop_size < h:
        hs.append(h - crop_size)
    if ws[-1] + crop_size < w:
        ws.append(w - crop_size)
    logits = torch.zeros(b, h, w, num_classes, dtype=torch.float32,
                         device=x.device)
    count = torch.zeros(1, h, w, 1, dtype=torch.float32, device=x.device)
    ch, cw = min(crop_size, h), min(crop_size, w)
    for y0 in hs:
        for x0 in ws:
            out = apply_fn(x[:, y0:y0 + ch, x0:x0 + cw]).float()
            logits[:, y0:y0 + out.shape[1], x0:x0 + out.shape[2]] += out
            count[:, y0:y0 + out.shape[1], x0:x0 + out.shape[2]] += 1.0
    return logits / count.clamp(min=1.0)
