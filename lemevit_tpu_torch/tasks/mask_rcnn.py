"""Mask R-CNN: an axis-aligned two-stage detector with an instance mask
head; counterpart of lemevit_tpu/tasks/mask_rcnn.py (the reference's
COCO config, object_detection/configs/mask_rcnn/
lemevit_small_mask_rcnn_r50_fpn_1x_coco.py): the LeMeViT pyramid -> FPN
-> RPN (xywh deltas) -> RoI align -> box head (class and box) and mask
head (4 convs, a 2x2 stride-2 transposed conv, per-class masks).

Shapes stay fixed as in the JAX package: the proposals are the top-K of
every anchor's score (a stable descending sort, ``lax.top_k``'s order on
ties; tasks/detection.top_k), ground truth is padded with a validity
mask, and the eval keeps its NMS survivors as a mask. Module names are
the JAX package's (``backbone``, ``neck``, ``rpn.rpn_{conv,cls,reg}``,
``box_head.{fc1,fc2,cls,reg}``, ``mask_head.{conv0..3,upsample,mask}``),
so models/convert.py::from_jax_maskrcnn moves its variables in. The RPN's
classifier and regressor, the box head's ``cls`` / ``reg`` and the mask
head's ``mask`` run in fp32 outside autocast, as the JAX package's
``dtype=jnp.float32`` layers. The box head flattens the pooled
(K, 7, 7, C) NHWC features, as JAX does. Gradients reach the RPN's deltas
through the proposals (the RoI sample coordinates and the RoI-frame box
targets), as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import init_weights, nhwc_conv
from lemevit_tpu_torch.ops.boxes import batched_nms, box_iou
from lemevit_tpu_torch.ops.roi import multilevel_roi_align, roi_align
from lemevit_tpu_torch.tasks.change_detection import (feature_channels,
                                                      fp32_conv)
from lemevit_tpu_torch.tasks.detection import FPN, make_anchors, top_k
from lemevit_tpu_torch.tasks.detection_train import (_weighted_mean,
                                                     max_iou_assign,
                                                     sample_weights,
                                                     smooth_l1)
from lemevit_tpu_torch.tasks.snunet import conv_transpose_same


def encode_boxes(anchors_xywh: torch.Tensor, gt_xyxy: torch.Tensor
                 ) -> torch.Tensor:
    """The standard delta coder (dx, dy, dw, dh); any leading dims."""
    gx = (gt_xyxy[..., 0] + gt_xyxy[..., 2]) / 2
    gy = (gt_xyxy[..., 1] + gt_xyxy[..., 3]) / 2
    gw = (gt_xyxy[..., 2] - gt_xyxy[..., 0]).clamp(min=1e-3)
    gh = (gt_xyxy[..., 3] - gt_xyxy[..., 1]).clamp(min=1e-3)
    ax, ay, aw, ah = anchors_xywh.unbind(-1)
    aw, ah = aw.clamp(min=1e-3), ah.clamp(min=1e-3)
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], -1)


def decode_boxes(anchors_xywh: torch.Tensor, deltas: torch.Tensor
                 ) -> torch.Tensor:
    """The inverse of encode_boxes -> xyxy (dw, dh clipped to +-4)."""
    ax, ay, aw, ah = anchors_xywh.unbind(-1)
    cx = ax + deltas[..., 0] * aw
    cy = ay + deltas[..., 1] * ah
    w = aw * torch.exp(deltas[..., 2].clamp(-4, 4))
    h = ah * torch.exp(deltas[..., 3].clamp(-4, 4))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_xywh(xyxy: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        (xyxy[..., 0] + xyxy[..., 2]) / 2, (xyxy[..., 1] + xyxy[..., 3]) / 2,
        (xyxy[..., 2] - xyxy[..., 0]).clamp(min=1e-3),
        (xyxy[..., 3] - xyxy[..., 1]).clamp(min=1e-3)], -1)


class RPNHead(nn.Module):
    """A shared 3x3 conv and ReLU, then per anchor an objectness logit and
    (dx, dy, dw, dh), fp32. Returns per-level (B, H, W, A) scores and
    (B, H, W, 4 A) deltas."""

    def __init__(self, in_channels: int, feat_channels: int = 256,
                 num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        scores, deltas = [], []
        for f in feats:
            h = F.relu(nhwc_conv(self.rpn_conv, f))
            scores.append(fp32_conv(self.rpn_cls, h))
            deltas.append(fp32_conv(self.rpn_reg, h))
        return scores, deltas


class BoxHead(nn.Module):
    """Two FC layers on the flattened NHWC RoI features, then class logits
    (background last) and (dx, dy, dw, dh), fp32."""

    def __init__(self, in_features: int, num_classes: int,
                 fc_channels: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_features, fc_channels)
        self.fc2 = nn.Linear(fc_channels, fc_channels)
        self.cls = nn.Linear(fc_channels, num_classes + 1)
        self.reg = nn.Linear(fc_channels, 4)

    def forward(self, pooled: torch.Tensor):
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            return tuple(F.linear(x, fc.weight.float(), fc.bias.float())
                         for fc in (self.cls, self.reg))


class MaskHead(nn.Module):
    """``num_convs`` 3x3 convs with ReLU, a 2x2 stride-2 transposed conv
    (flax's ConvTranspose, "SAME", unflipped: tasks/snunet.
    conv_transpose_same) with ReLU, a 1x1 conv to per-class logits in
    fp32. NHWC (K, r, r, C) -> (K, 2 r, 2 r, num_classes)."""

    def __init__(self, in_channels: int, num_classes: int,
                 channels: int = 256, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else channels, channels, 3, padding=1))
        self.upsample = nn.Conv2d(channels, channels, 2)
        self.mask = nn.Conv2d(channels, num_classes, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled
        for i in range(self.num_convs):
            x = F.relu(nhwc_conv(getattr(self, f"conv{i}"), x))
        x = F.relu(nhwc_conv(lambda t: conv_transpose_same(self.upsample, t),
                             x))
        return fp32_conv(self.mask, x)


class MaskRCNN(nn.Module):
    """Fixed-shape Mask R-CNN over a features_only backbone.

    Eval mode returns {"boxes" (B, K, 4) xyxy, "scores" (B, K) (0 where
    not kept), "labels" (B, K), "keep" (B, K), "masks" (B, K, 2 m, 2 m,
    num_classes) sigmoid probabilities}, K = num_proposals, m =
    mask_roi_size; train mode the raw outputs mask_rcnn_loss reads."""

    def __init__(self, backbone: nn.Module, num_classes: int = 80,
                 fpn_channels: int = 256, num_proposals: int = 128,
                 roi_size: int = 7, mask_roi_size: int = 14,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 score_thr: float = 0.05, nms_iou: float = 0.5):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.num_proposals = num_proposals
        self.roi_size, self.mask_roi_size = roi_size, mask_roi_size
        self.strides = tuple(strides)
        self.score_thr, self.nms_iou = score_thr, nms_iou
        levels = len(getattr(backbone, "out_indices", None)
                     or backbone.out_channels)  # LeMeViT or a CNN
        self.neck = FPN([feature_channels(backbone, i)
                         for i in range(levels)], fpn_channels,
                        num_outs=len(self.strides))
        self.rpn = RPNHead(fpn_channels, fpn_channels)
        self.box_head = BoxHead(roi_size * roi_size * fpn_channels,
                                num_classes)
        self.mask_head = MaskHead(fpn_channels, num_classes)

    def forward(self, images: torch.Tensor,
                proposals: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The forward of JAX's MaskRCNN.__call__ on NHWC ``images``.
        ``proposals`` is for checks only, not in JAX's signature: where
        given, the (B, K, 4) boxes replace the RPN's top-K, so that two
        attention paths can be compared on the same RoIs (chip_smoke.py's
        maskrcnn phase); training and prediction never pass it."""
        b = images.shape[0]
        pyramid = self.neck(self.backbone(images))
        scores, deltas = self.rpn(pyramid)
        anchors = torch.cat(make_anchors([f.shape[1:3] for f in pyramid],
                                         self.strides, device=images.device))
        all_scores = torch.cat([s.reshape(b, -1) for s in scores], dim=1)
        all_deltas = torch.cat([d.reshape(b, -1, 4) for d in deltas], dim=1)
        k = self.num_proposals
        if proposals is None:
            _, topi = top_k(all_scores, k)
            proposals = decode_boxes(
                anchors[topi],
                torch.take_along_dim(all_deltas, topi[..., None], dim=1))
        bidx = torch.arange(b, device=images.device, dtype=proposals.dtype)
        rois = torch.cat([bidx[:, None, None].expand(b, k, 1), proposals],
                         dim=-1).reshape(b * k, 5)
        strides4 = self.strides[:4]
        pooled = multilevel_roi_align(pyramid[:4], rois,
                                      (self.roi_size, self.roi_size),
                                      strides4, aligned=True)
        cls, reg = self.box_head(pooled)
        mask_pooled = multilevel_roi_align(
            pyramid[:4], rois, (self.mask_roi_size, self.mask_roi_size),
            strides4, aligned=True)
        masks = self.mask_head(mask_pooled)
        masks = masks.reshape(b, k, *masks.shape[1:])
        if self.training:
            return {"rpn_scores": all_scores, "rpn_deltas": all_deltas,
                    "anchors": anchors, "proposals": proposals,
                    "roi_cls": cls.reshape(b, k, -1),
                    "roi_reg": reg.reshape(b, k, 4), "masks": masks,
                    "rois": rois}
        boxes = decode_boxes(xyxy_to_xywh(rois[:, 1:]), reg).reshape(b, k, 4)
        probs = torch.softmax(cls, dim=-1).reshape(b, k, -1)[..., :-1]
        best, labels = probs.max(-1).values, probs.argmax(-1)
        keep = torch.stack([batched_nms(bx, sc, lb, self.nms_iou)
                            for bx, sc, lb in zip(boxes, best, labels)])
        keep = keep & (best > self.score_thr)
        return {"boxes": boxes, "scores": best * keep, "labels": labels,
                "keep": keep, "masks": torch.sigmoid(masks)}


def create_mask_rcnn(backbone: str, *, device=None, seed: int = 0,
                     backbone_kwargs: Optional[dict] = None,
                     **kwargs) -> MaskRCNN:
    """MaskRCNN over a registry backbone (features_only) from ``seed``:
    the backbone's weights are create_model(backbone, seed=seed)'s, the
    neck's and heads' drawn from a generator seeded ``seed + 1``
    (core/layers.init_weights)."""
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    bb = create_model(backbone, device="cpu", seed=seed, features_only=True,
                      **(backbone_kwargs or {}))
    model = MaskRCNN(bb, **kwargs)
    gen = torch.Generator().manual_seed(seed + 1)
    for head in (model.neck, model.rpn, model.box_head, model.mask_head):
        init_weights(head, gen)
    return model.to(resolve_device(device))


def mask_rcnn_loss(out: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                   gt_mask_valid: torch.Tensor, num_classes: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The batched loss from MaskRCNN's train-mode outputs: the five parts
    (rpn_cls, rpn_reg, roi_cls, roi_reg, mask), each averaged over the
    images, and their sum. gt_boxes (B, G, 4) xyxy padded, gt_labels
    (B, G), gt_masks (B, G, Hm, Wm) binary at full image resolution,
    gt_mask_valid (B, G). Each roi's mask target is its best gt's mask
    cropped by roi_align to the roi (sampled in place: roi r reads gt
    mask best_gt[r]) and thresholded at 0.5; the mask BCE takes the
    target class's channel (clipped to num_classes - 1) and is weighted
    as the box regression."""
    props = out["proposals"]
    b, k, _ = props.shape
    anchors = out["anchors"]
    anchors_xyxy = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2,
                              anchors[:, :2] + anchors[:, 2:] / 2], -1)
    gtl = gt_labels.long()

    labels01, assigned = max_iou_assign(anchors_xyxy, gt_boxes,
                                        gt_mask_valid, pos_thr=0.7,
                                        neg_thr=0.3)
    cls_w, reg_w = sample_weights(labels01, 256)
    scores = out["rpn_scores"].float()
    tgt = (labels01 == 1).float()
    bce = -(tgt * F.logsigmoid(scores) + (1 - tgt) * F.logsigmoid(-scores))
    rpn_tgt = encode_boxes(anchors, torch.take_along_dim(
        gt_boxes, assigned[..., None], dim=1))
    rpn_reg = smooth_l1(out["rpn_deltas"].float(), rpn_tgt).sum(-1)

    with torch.no_grad():  # decisions only
        iou = box_iou(props, gt_boxes)                   # (B, K, G)
        iou = torch.where(gt_mask_valid[:, None, :], iou,
                          torch.full_like(iou, -1.0))
        best_iou, best_gt = iou.max(dim=-1).values, iou.argmax(dim=-1)
    roi01 = torch.where(best_iou >= 0.5, 1, torch.where(best_iou >= 0, 0, -1))
    rcls_w, rreg_w = sample_weights(roi01, 128, pos_fraction=0.25)
    cls_tgt = torch.where(roi01 == 1, torch.take_along_dim(gtl, best_gt, 1),
                          num_classes)
    logp = F.log_softmax(out["roi_cls"].float(), -1)
    roi_ce = -torch.take_along_dim(logp, cls_tgt[..., None], dim=-1)[..., 0]
    reg_tgt = encode_boxes(xyxy_to_xywh(props), torch.take_along_dim(
        gt_boxes, best_gt[..., None], dim=1))
    roi_l1 = smooth_l1(out["roi_reg"].float(), reg_tgt).sum(-1)

    masks = out["masks"]
    ms = masks.shape[2]
    g, hm, wm = gt_masks.shape[1:4]
    with torch.no_grad():  # the target is thresholded: no gradient
        src = (torch.arange(b, device=props.device)[:, None] * g
               + best_gt).reshape(-1, 1).to(props.dtype)
        crops = roi_align(
            gt_masks.reshape(b * g, hm, wm, 1).float(),
            torch.cat([src, props.reshape(-1, 4)], -1), (ms, ms),
            aligned=True)[..., 0].reshape(b, k, ms, ms)
    sel = torch.take_along_dim(
        masks.float(),
        cls_tgt.clamp(0, num_classes - 1)[..., None, None, None], dim=-1
    )[..., 0]
    mbce = (sel.clamp(min=0) - sel * (crops > 0.5)
            + torch.log1p(torch.exp(-sel.abs())))
    parts = {"rpn_cls": _weighted_mean(bce, cls_w),
             "rpn_reg": _weighted_mean(rpn_reg, reg_w),
             "roi_cls": _weighted_mean(roi_ce, rcls_w),
             "roi_reg": _weighted_mean(roi_l1, rreg_w),
             "mask": _weighted_mean(mbce.mean(dim=(2, 3)), rreg_w)}
    parts = {n: v.mean() for n, v in parts.items()}
    return sum(parts.values()), parts
