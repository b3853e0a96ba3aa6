"""Batch augmentation on the device: mixup / cutmix and random erasing,
counterpart of lemevit_tpu/data/mixup.py (timm's batch-mode Mixup, alphas
0.8 / 1.0, switch 0.5; RandomErasing in pixel mode, prob 0.25). Images are
normalised float NHWC (data/transforms.py::normalize).

Each is split into a random draw and a deterministic apply, so that an
apply can be held to the JAX package's on the same draw:
  draw_mixup(rng, h, w, ...)        -> MixupDraw (host scalars from a
                                       numpy Generator: no device sync)
  mixup_cutmix(images, labels, num_classes, draw, label_smoothing)
  draw_erasing(generator, b, h, w, ...) -> per-image boxes, drawn on the
                                       generator's device
  row_noise(seeds, shape, device)   -> the erasing noise, one seed a row
  random_erasing(images, draw, noise)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class MixupDraw:
    """One batch's mixup / cutmix decision. ``mode`` is "mixup", "cutmix"
    or "none"; ``lam`` the weight of the unflipped batch (mixup: the pixel
    weight; cutmix: 1 - box area / image area); ``box`` (y0, y1, x0, x1) the
    region cutmix takes from the flipped batch."""
    mode: str
    lam: float = 1.0
    box: Tuple[int, int, int, int] = (0, 0, 0, 0)


def draw_mixup(rng: np.random.Generator, h: int, w: int,
               mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
               prob: float = 1.0, switch_prob: float = 0.5) -> MixupDraw:
    """Draw one batch's MixupDraw. With both alphas above 0 cutmix is taken
    with ``switch_prob``; with one of them 0 the other mode always (timm's
    choice; the JAX package would draw Beta(0, 0) there)."""
    if rng.random() >= prob or (mixup_alpha <= 0 and cutmix_alpha <= 0):
        return MixupDraw("none")
    if mixup_alpha > 0 and cutmix_alpha > 0:
        cut = rng.random() < switch_prob
    else:
        cut = cutmix_alpha > 0
    if not cut:
        return MixupDraw("mixup", float(rng.beta(mixup_alpha, mixup_alpha)))
    lam = float(rng.beta(cutmix_alpha, cutmix_alpha))
    ratio = math.sqrt(1.0 - lam)
    cut_h, cut_w = int(ratio * h), int(ratio * w)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    y0, y1 = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
    x0, x1 = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
    box = (int(y0), int(y1), int(x0), int(x1))
    return MixupDraw("cutmix", 1.0 - (y1 - y0) * (x1 - x0) / (h * w), box)


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, draw: MixupDraw,
                 label_smoothing: float = 0.1,
                 partner: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix each sample with its partner in the reversed batch as ``draw``
    says. Returns (images, soft targets (B, num_classes) float32).
    ``partner`` (images, labels), whose reversed rows are the partners of
    these, defaults to this batch; in a data-parallel step it is the mirror
    rank's rows (parallel/distributed.py::Shard.mirror), so that row i of
    the global batch pairs with row G - 1 - i."""
    p_images, p_labels = partner if partner is not None else (images,
                                                              labels)
    flipped = p_images.flip(0)
    if draw.mode == "mixup":
        images = draw.lam * images + (1.0 - draw.lam) * flipped
    elif draw.mode == "cutmix":
        y0, y1, x0, x1 = draw.box
        images = images.clone()
        images[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
    y1h = F.one_hot(labels, num_classes).float()
    y2h = F.one_hot(p_labels, num_classes).float().flip(0)
    targets = draw.lam * y1h + (1.0 - draw.lam) * y2h
    if label_smoothing > 0:
        targets = (targets * (1.0 - label_smoothing)
                   + label_smoothing / num_classes)
    return images, targets


def draw_erasing(generator: torch.Generator, b: int, h: int, w: int,
                 prob: float = 0.25,
                 scale: Tuple[float, float] = (0.02, 1.0 / 3.0),
                 ratio: Tuple[float, float] = (0.3, 3.3)
                 ) -> Dict[str, torch.Tensor]:
    """Per-image erasing boxes on the generator's device: {"apply" (B,)
    bool, "y0", "x0", "eh", "ew" (B,) int64}, with the JAX package's
    formulas."""
    def u(lo=0.0, hi=1.0):
        r = torch.rand(b, generator=generator, device=generator.device)
        return lo + (hi - lo) * r

    apply = u() < prob
    area = u(*scale) * (h * w)
    aspect = torch.exp(u(math.log(ratio[0]), math.log(ratio[1])))
    eh = torch.sqrt(area * aspect).clamp(1, h).long()
    ew = torch.sqrt(area / aspect).clamp(1, w).long()
    y0 = (u() * (h - eh).float()).long()
    x0 = (u() * (w - ew).float()).long()
    return {"apply": apply, "y0": y0, "x0": x0, "eh": eh, "ew": ew}


def row_noise(seeds: torch.Tensor, shape: Tuple[int, ...],
              device) -> torch.Tensor:
    """Gaussian noise (len(seeds), *shape) in float32 on ``device``, row i
    drawn from a generator seeded with seeds[i] alone: a row's noise does
    not depend on the rows drawn beside it, so a rank draws only its own
    rows of the global batch (one launch a row)."""
    out = torch.empty((len(seeds),) + tuple(shape), device=device)
    g = torch.Generator(device=device)
    for row, seed in zip(out, seeds.tolist()):
        g.manual_seed(seed)
        row.normal_(generator=g)
    return out


def random_erasing(images: torch.Tensor, draw: Dict[str, torch.Tensor],
                   noise: torch.Tensor) -> torch.Tensor:
    """Replace each applied image's box by ``noise`` (same shape as the
    images; gaussian in pixel mode)."""
    _, h, w, _ = images.shape
    d = {k: v.to(images.device)[:, None, None] for k, v in draw.items()}
    yy = torch.arange(h, device=images.device)[None, :, None]
    xx = torch.arange(w, device=images.device)[None, None, :]
    mask = ((yy >= d["y0"]) & (yy < d["y0"] + d["eh"])
            & (xx >= d["x0"]) & (xx < d["x0"] + d["ew"]) & d["apply"])
    return torch.where(mask[..., None], noise, images)
