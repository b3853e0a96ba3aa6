"""Oriented object detection: FPN neck + Oriented RPN + rotated RoI head;
counterpart of lemevit_tpu/tasks/detection.py (the reference's
OBBDetection overlay, object_detection/configs/obb/oriented_rcnn/
faster_rcnn_orpn_lemevit_small_rsp_fpn_1x_dota10.py:14-84): the LeMeViT
pyramid -> FPN (5 outputs) -> OrientedRPNHead (midpoint-offset boxes) ->
rotated RoI align -> box head with (dx, dy, dw, dh, dtheta) regression,
class scores, rotated NMS.

Shapes stay fixed as in the JAX package: per-level top-k, NMS as keep
masks with suppressed rows at score -inf, a fixed number of proposals per
image. Top-k is a stable descending sort (``lax.top_k`` puts the lower
index first on ties, and which -inf row fills a slot follows that order),
and proposal selection and the eval's NMS run batched over images.

Module names are the JAX package's (``backbone``, ``neck.lateral{i}``,
``neck.fpn{i}``, ``rpn.rpn_{conv,cls,reg}``, ``roi_head.{fc1,fc2,cls,
reg}``), so models/convert.py::from_jax_det moves its variables in. The
RPN's classifier and regressor and the RoI head's ``cls`` / ``reg`` run in
fp32 outside autocast, as the JAX package's ``dtype=jnp.float32`` layers.
Gradients are not stopped at the proposals: they reach the RPN's deltas
through the RoI sample coordinates and the RoI-frame targets, as in the
JAX package (mmdet detaches them).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lemevit_tpu_torch.core.layers import init_weights, nhwc_conv
from lemevit_tpu_torch.ops.roi import level_of, roi_align_rotated
from lemevit_tpu_torch.ops.rotated import obb_nms
from lemevit_tpu_torch.tasks.change_detection import (feature_channels,
                                                      fp32_conv)
from lemevit_tpu_torch.tasks.upernet import resize


class FPN(nn.Module):
    """Feature pyramid network neck: laterals, top-down sum (nearest
    upsampling), 3x3 outputs, and extra levels by stride-2 subsampling
    (flax's max_pool with a 1x1 window). NHWC in and out."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        for i, ch in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(ch, out_channels, 1))
            setattr(self, f"fpn{i}", nn.Conv2d(out_channels, out_channels,
                                               3, padding=1))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [nhwc_conv(getattr(self, f"lateral{i}"), f)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[1:3]
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], (h, w), method="nearest")
        outs = [nhwc_conv(getattr(self, f"fpn{i}"), lat)
                for i, lat in enumerate(laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])
        return outs


class OrientedRPNHead(nn.Module):
    """RPN predicting midpoint-offset oriented boxes: per anchor
    (dx, dy, dw, dh, da, db) and objectness (the Oriented R-CNN encoding).
    Returns per-level (B, H, W, A) scores and (B, H, W, 6 A) deltas, fp32."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 6, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_scores, bbox_preds = [], []
        for f in feats:
            h = F.relu(nhwc_conv(self.rpn_conv, f))
            cls_scores.append(fp32_conv(self.rpn_cls, h))
            bbox_preds.append(fp32_conv(self.rpn_reg, h))
        return cls_scores, bbox_preds


def make_anchors(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 scale: float = 8.0,
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 device=None) -> List[torch.Tensor]:
    """Per-level anchor grids (H W A, 4) xywh (axis-aligned bases)."""
    out = []
    for (h, w), s in zip(shapes, strides):
        ws = torch.tensor([s * scale * (r ** -0.5) for r in ratios],
                          device=device)
        hs = torch.tensor([s * scale * (r ** 0.5) for r in ratios],
                          device=device)
        cx = (torch.arange(w, device=device) + 0.5) * s
        cy = (torch.arange(h, device=device) + 0.5) * s
        cyy, cxx = torch.meshgrid(cy, cx, indexing="ij")
        centers = torch.stack([cxx, cyy], -1).reshape(-1, 1, 2)
        sizes = torch.stack([ws, hs], -1)[None]  # (1, A, 2)
        anchors = torch.cat(
            [centers.expand(h * w, len(ratios), 2),
             sizes.expand(h * w, len(ratios), 2)], -1)
        out.append(anchors.reshape(-1, 4).float())
    return out


def decode_midpoint_offset(anchors: torch.Tensor, deltas: torch.Tensor
                           ) -> torch.Tensor:
    """Midpoint-offset decoding -> rotated boxes (cx, cy, w, h, theta).

    anchors (..., 4) xywh; deltas (..., 6) = (dx, dy, dw, dh, da, db): the
    first four decode the external (axis-aligned) box, (da, db) is the
    center -> right-edge-midpoint vector of the oriented box normalized by
    the external box dims (exactly invertible for theta in (-pi/2, pi/2);
    detection_train.encode_midpoint_offset is the inverse)."""
    ax, ay, aw, ah = anchors.unbind(-1)
    dx, dy, dw, dh, da, db = deltas.unbind(-1)
    gx = ax + dx * aw
    gy = ay + dy * ah
    gw = aw * torch.exp(dw.clamp(-4, 4))
    gh = ah * torch.exp(dh.clamp(-4, 4))
    # zero deltas decode to the axis-aligned external box itself
    vx = (0.5 + da.clamp(-0.45, 0.25)) * gw  # right-edge midpoint vector
    vy = db.clamp(-0.75, 0.75) * gh
    w_r = 2 * torch.sqrt(vx * vx + vy * vy)
    theta = torch.atan2(vy, vx.clamp(min=1e-6))
    # external height = w |sin t| + h cos t  ->  recover h
    cos_t = torch.cos(theta).clamp(min=1e-3)
    h_r = ((gh - w_r * torch.sin(theta).abs()) / cos_t).clamp(min=1e-3)
    return torch.stack([gx, gy, w_r, h_r, theta], -1)


def encode_obb_deltas(rois: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Deltas (dx, dy, dw, dh, dtheta) from rotated rois to rotated gts, in
    the roi frame (the standard rotated-box coder). (..., 5) each."""
    cos_t = torch.cos(rois[..., 4])
    sin_t = torch.sin(rois[..., 4])
    dx_g = gts[..., 0] - rois[..., 0]
    dy_g = gts[..., 1] - rois[..., 1]
    dx = (cos_t * dx_g + sin_t * dy_g) / rois[..., 2].clamp(min=1e-3)
    dy = (-sin_t * dx_g + cos_t * dy_g) / rois[..., 3].clamp(min=1e-3)
    dw = torch.log(gts[..., 2].clamp(min=1e-3)
                   / rois[..., 2].clamp(min=1e-3))
    dh = torch.log(gts[..., 3].clamp(min=1e-3)
                   / rois[..., 3].clamp(min=1e-3))
    dt = gts[..., 4] - rois[..., 4]
    dt = torch.atan2(torch.sin(dt), torch.cos(dt))  # wrap to (-pi, pi]
    return torch.stack([dx, dy, dw, dh, dt], -1)


def decode_obb_deltas(rois: torch.Tensor, deltas: torch.Tensor
                      ) -> torch.Tensor:
    cos_t = torch.cos(rois[..., 4])
    sin_t = torch.sin(rois[..., 4])
    gx = (rois[..., 0] + rois[..., 2] * deltas[..., 0] * cos_t
          - rois[..., 3] * deltas[..., 1] * sin_t)
    gy = (rois[..., 1] + rois[..., 2] * deltas[..., 0] * sin_t
          + rois[..., 3] * deltas[..., 1] * cos_t)
    gw = rois[..., 2] * torch.exp(deltas[..., 2].clamp(-4, 4))
    gh = rois[..., 3] * torch.exp(deltas[..., 3].clamp(-4, 4))
    gt = rois[..., 4] + deltas[..., 4]
    return torch.stack([gx, gy, gw, gh, gt], -1)


def multilevel_roi_align_rotated(pyramid: Sequence[torch.Tensor],
                                 rois: torch.Tensor, output_size, strides,
                                 canonical_scale: float = 224.0
                                 ) -> torch.Tensor:
    """FPN-level-assigned rotated RoI align: every roi pooled from every
    level, the level of its area selected by a mask (the scheme of
    ops.roi.multilevel_roi_align). rois (K, 6)."""
    areas = (rois[:, 3] * rois[:, 4]).clamp(min=1e-6)
    lvl = level_of(areas, len(pyramid), canonical_scale)
    out = None
    for i, (feat, s) in enumerate(zip(pyramid, strides)):
        pooled = roi_align_rotated(feat, rois, output_size,
                                   spatial_scale=1.0 / s)
        sel = (lvl == i)[:, None, None, None].to(pooled.dtype)
        out = pooled * sel if out is None else out + pooled * sel
    return out


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, the lower index
    first among equal values (a stable descending sort; ``torch.topk``
    orders ties otherwise)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def select_proposals(cls_scores: Sequence[torch.Tensor],
                     bbox_preds: Sequence[torch.Tensor],
                     anchors: Sequence[torch.Tensor], num_proposals: int,
                     nms_pre: int = 512,
                     nms_thr: Optional[float] = 0.8) -> torch.Tensor:
    """RPN proposal selection with fixed shapes: per-level nms_pre top-k ->
    decode -> rotated NMS within each level (every image of the batch at
    once) -> global top-K (OBBDetection's RPN contract:
    nms_across_levels=False, nms_pre / nms_thr / max_num). Suppressed rows
    keep their slot at score -inf and are still picked as fillers when
    fewer rows survive; nms_thr=None skips NMS. Returns (B, K, 5)."""
    b = cls_scores[0].shape[0]
    lvl_scores, lvl_boxes = [], []
    for s_lvl, p_lvl, a_lvl in zip(cls_scores, bbox_preds, anchors):
        sc = s_lvl.reshape(b, -1)
        dl = p_lvl.reshape(b, -1, 6)
        topv, topi = top_k(sc, min(nms_pre, sc.shape[1]))
        dec = decode_midpoint_offset(
            a_lvl[topi], torch.take_along_dim(dl, topi[..., None], dim=1))
        if nms_thr is not None:
            keep = obb_nms(dec, topv, nms_thr)
            topv = torch.where(keep, topv,
                               torch.full_like(topv, -torch.inf))
        lvl_scores.append(topv)
        lvl_boxes.append(dec)
    cat_scores = torch.cat(lvl_scores, dim=1)
    cat_boxes = torch.cat(lvl_boxes, dim=1)
    if cat_scores.shape[1] < num_proposals:
        # fewer candidates than requested proposals: -inf slots, boxes 0
        pad = num_proposals - cat_scores.shape[1]
        cat_scores = F.pad(cat_scores, (0, pad), value=-torch.inf)
        cat_boxes = F.pad(cat_boxes, (0, 0, 0, pad))
    _, sel = top_k(cat_scores, num_proposals)
    return torch.take_along_dim(cat_boxes, sel[..., None], dim=1)


class OBBRoIHead(nn.Module):
    """Rotated RoI head: multi-level roi_align_rotated -> 2 FC -> class
    logits (background last) and obb regression, both fp32."""

    def __init__(self, in_channels: int, num_classes: int,
                 fc_channels: int = 1024, roi_size: int = 7):
        super().__init__()
        self.roi_size = roi_size
        self.fc1 = nn.Linear(roi_size * roi_size * in_channels, fc_channels)
        self.fc2 = nn.Linear(fc_channels, fc_channels)
        self.cls = nn.Linear(fc_channels, num_classes + 1)
        self.reg = nn.Linear(fc_channels, 5)

    def forward(self, pyramid, rois: torch.Tensor, strides):
        pooled = multilevel_roi_align_rotated(
            pyramid, rois, (self.roi_size, self.roi_size), strides)
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            return tuple(F.linear(x, fc.weight.float(), fc.bias.float())
                         for fc in (self.cls, self.reg))


class OrientedRCNN(nn.Module):
    """Two-stage oriented detector with fixed shapes throughout.

    In eval mode it returns {"boxes" (B, K, 5), "scores" (B, K) (0 where
    not kept), "labels" (B, K), "keep" (B, K)}, K = num_proposals; in train
    mode the RPN's and the RoI head's raw outputs for
    detection_train.detection_loss. ``rpn_nms_pre`` is the per-level
    pre-NMS top-k (the reference config: 2000)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 15,
                 fpn_channels: int = 256, num_proposals: int = 256,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 score_thr: float = 0.05, nms_iou: float = 0.1,
                 rpn_nms_pre: int = 512, rpn_nms_thr: float = 0.8,
                 rpn_nms: bool = True):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.num_proposals = num_proposals
        self.strides = tuple(strides)
        self.score_thr = score_thr
        self.nms_iou = nms_iou
        self.rpn_nms_pre = rpn_nms_pre
        self.rpn_nms_thr = rpn_nms_thr
        self.rpn_nms = rpn_nms
        levels = len(getattr(backbone, "out_indices", None)
                     or backbone.out_channels)  # LeMeViT or a CNN
        self.neck = FPN([feature_channels(backbone, i)
                         for i in range(levels)], fpn_channels,
                        num_outs=len(self.strides))
        self.rpn = OrientedRPNHead(fpn_channels)  # 256 wide, as JAX's
        self.roi_head = OBBRoIHead(fpn_channels, num_classes)

    def forward(self, images: torch.Tensor,
                proposals: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """The forward of JAX's OrientedRCNN.__call__ on NHWC ``images``.
        ``proposals`` is for checks only, not in JAX's signature: where
        given, the (B, K, 5) boxes replace the RPN's selection, so that two
        attention paths can be compared on the same RoIs (chip_smoke.py's
        det phase); training and prediction never pass it."""
        b = images.shape[0]
        pyramid = self.neck(self.backbone(images))
        cls_scores, bbox_preds = self.rpn(pyramid)
        anchors = make_anchors([f.shape[1:3] for f in pyramid], self.strides,
                               device=images.device)
        k = self.num_proposals
        if proposals is None:
            proposals = select_proposals(
                cls_scores, bbox_preds, anchors, k, nms_pre=self.rpn_nms_pre,
                nms_thr=self.rpn_nms_thr if self.rpn_nms else None)
        bidx = torch.arange(b, device=images.device, dtype=proposals.dtype)
        rois = torch.cat([bidx[:, None, None].expand(b, k, 1), proposals],
                         dim=-1).reshape(b * k, 6)
        cls, reg = self.roi_head(pyramid[:4], rois, self.strides[:4])
        if self.training:
            return {"rpn_scores": torch.cat(
                        [s.reshape(b, -1) for s in cls_scores], dim=1),
                    "rpn_deltas": torch.cat(
                        [p.reshape(b, -1, 6) for p in bbox_preds], dim=1),
                    "anchors": torch.cat(anchors, dim=0),
                    "proposals": proposals,
                    "roi_cls": cls.reshape(b, k, -1),
                    "roi_reg": reg.reshape(b, k, 5), "rois": rois}
        boxes = decode_obb_deltas(rois[:, 1:], reg).reshape(b, k, 5)
        scores = torch.softmax(cls, dim=-1).reshape(b, k, -1)[..., :-1]
        best_scores, labels = scores.max(-1).values, scores.argmax(-1)
        keep = obb_nms(boxes, best_scores, self.nms_iou)
        keep = keep & (best_scores > self.score_thr)
        return {"boxes": boxes, "scores": best_scores * keep,
                "labels": labels, "keep": keep}


def create_oriented_rcnn(backbone: str, *, device=None, seed: int = 0,
                         backbone_kwargs: Optional[dict] = None,
                         **kwargs) -> OrientedRCNN:
    """OrientedRCNN over a registry backbone (features_only, out_indices
    (1, 2, 3, 4) for LeMeViT), from ``seed``: the backbone's weights are
    create_model(backbone, seed=seed)'s, the neck's and heads' drawn from
    a generator seeded ``seed + 1`` (core/layers.init_weights)."""
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    bb = create_model(backbone, device="cpu", seed=seed, features_only=True,
                      **(backbone_kwargs or {}))
    model = OrientedRCNN(bb, **kwargs)
    gen = torch.Generator().manual_seed(seed + 1)
    for head in (model.neck, model.rpn, model.roi_head):
        init_weights(head, gen)
    return model.to(resolve_device(device))
