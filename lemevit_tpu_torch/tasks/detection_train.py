"""Detection training: anchor assignment, sampling, RPN and RoI losses;
counterpart of lemevit_tpu/tasks/detection_train.py (fixed-shape
equivalents of the mm-style MaxIoUAssigner, RandomSampler, delta coders and
smooth-L1 / CE losses of the reference's config,
object_detection/configs/obb/oriented_rcnn/
faster_rcnn_orpn_lemevit_small_rsp_fpn_1x_dota10.py:14-84):
  - ground truth is padded to a fixed K with a validity mask;
  - assignment gives per-anchor labels {-1 ignore, 0 neg, 1 pos};
  - "sampling" is a soft cap: per-anchor weights normalized to the target
    positive / negative counts (deterministic, no data-dependent shapes).
Every function takes the images of a batch along a leading dimension,
where the JAX package ``vmap``s a one-image function.

``max_iou_assign``'s force-match writes each valid gt's claim at its best
anchor. Where several gts share a best anchor, the one with the highest
gt index writes last and wins, what the JAX package's ``.at[...].set``
does on the CPU (XLA's scatter applies duplicate indices in order). A
padded gt's column is all -1, so its best anchor is anchor 0, and it
writes anchor 0's unforced label and gt back: a valid gt's claim on
anchor 0 is undone by any padded gt after it, in both packages.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.ops.boxes import box_iou
from lemevit_tpu_torch.ops.rotated import box_iou_rotated, obb_to_corners
from lemevit_tpu_torch.tasks.detection import encode_obb_deltas


def obb_to_aabb(obbs: torch.Tensor) -> torch.Tensor:
    """(..., 5) rotated -> (..., 4) xyxy outer box."""
    corners = obb_to_corners(obbs)  # (..., 4, 2)
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)


def canonicalize_obb(obbs: torch.Tensor) -> torch.Tensor:
    """Rotate the (w, h, theta) parametrization into theta in
    (-pi/2, pi/2]: a rotation by pi gives the same rectangle."""
    cx, cy, w, h, t = obbs.unbind(-1)
    t = torch.atan2(torch.sin(t), torch.cos(t))      # (-pi, pi]
    t = torch.where(t.abs() > math.pi / 2, t - torch.sign(t) * math.pi, t)
    return torch.stack([cx, cy, w, h, t], -1)


def encode_midpoint_offset(anchors: torch.Tensor, gt_obbs: torch.Tensor
                           ) -> torch.Tensor:
    """RPN regression targets (dx, dy, dw, dh, da, db) from xywh anchors
    (..., 4) to rotated gts (..., 5): the exact inverse of
    detection.decode_midpoint_offset. (da, db) is the center -> right-edge
    midpoint vector over the external box dims."""
    gt_obbs = canonicalize_obb(gt_obbs)
    aabb = obb_to_aabb(gt_obbs)
    gx = (aabb[..., 0] + aabb[..., 2]) / 2
    gy = (aabb[..., 1] + aabb[..., 3]) / 2
    gw = (aabb[..., 2] - aabb[..., 0]).clamp(min=1e-3)
    gh = (aabb[..., 3] - aabb[..., 1]).clamp(min=1e-3)
    w, t = gt_obbs[..., 2], gt_obbs[..., 4]
    da = (w / 2) * torch.cos(t) / gw - 0.5   # 0 == axis-aligned external
    db = (w / 2) * torch.sin(t) / gh
    ax, ay, aw, ah = anchors.unbind(-1)
    dx = (gx - ax) / aw.clamp(min=1e-3)
    dy = (gy - ay) / ah.clamp(min=1e-3)
    dw = torch.log(gw / aw.clamp(min=1e-3))
    dh = torch.log(gh / ah.clamp(min=1e-3))
    return torch.stack([dx, dy, dw, dh, da, db], -1)


def max_iou_assign(anchors_xyxy: torch.Tensor, gt_xyxy: torch.Tensor,
                   gt_mask: torch.Tensor, pos_thr: float = 0.7,
                   neg_thr: float = 0.3
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaxIoUAssigner: per-anchor (labels {-1, 0, 1}, assigned gt index),
    (B, A) each, for anchors (A, 4) and gts (B, K, 4) with mask (B, K).
    Every valid gt also claims its best anchor (mm's low-quality match;
    ties among gts as the module docstring says)."""
    iou = box_iou(anchors_xyxy, gt_xyxy)               # (B, A, K)
    iou = torch.where(gt_mask[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=-1).values, iou.argmax(dim=-1)
    labels = torch.where(best_iou >= pos_thr, 1,
                         torch.where((best_iou < neg_thr) & (best_iou >= 0),
                                     0, -1))
    # force-match each gt's best anchor; the last gt at an anchor wins
    gt_best_anchor = iou.argmax(dim=-2)                # (B, K)
    gt_best_iou = iou.amax(dim=-2)
    claim = gt_mask & (gt_best_iou > 1e-3)
    k = gt_xyxy.shape[-2]
    writer = torch.full_like(labels, -1).scatter_reduce(
        -1, gt_best_anchor,
        torch.arange(k, device=labels.device).expand_as(gt_best_anchor),
        reduce="amax")                                 # (B, A)
    wins = torch.take_along_dim(claim, writer.clamp(min=0), dim=-1) & (
        writer >= 0)
    labels = torch.where(wins, 1, labels)
    best_gt = torch.where(wins, writer, best_gt)
    return labels, best_gt


def sample_weights(labels: torch.Tensor, num: int = 256,
                   pos_fraction: float = 0.5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-budget sampling as per-anchor weights over the last dim:
    positives weighted num_pos_target / num_pos (capped at 1), negatives
    likewise; returns (cls_weights, reg_weights) summing to ~num."""
    pos = (labels == 1).float()
    neg = (labels == 0).float()
    n_pos = pos.sum(-1, keepdim=True)
    n_neg = neg.sum(-1, keepdim=True)
    want_pos = torch.clamp(n_pos, max=num * pos_fraction)
    want_neg = torch.minimum(num - want_pos, n_neg)
    w_pos = torch.where(n_pos > 0, want_pos / n_pos.clamp(min=1.0), 0.0)
    w_neg = torch.where(n_neg > 0, want_neg / n_neg.clamp(min=1.0), 0.0)
    return pos * w_pos + neg * w_neg, pos * w_pos


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def _weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x * w).sum(-1) / w.sum(-1).clamp(min=1.0)


def rpn_loss(scores: torch.Tensor, deltas: torch.Tensor,
             anchors: torch.Tensor, gt_obbs: torch.Tensor,
             gt_mask: torch.Tensor, num_samples: int = 256
             ) -> Dict[str, torch.Tensor]:
    """Per-image RPN losses (B,): scores (B, A), deltas (B, A, 6), anchors
    (A, 4) xywh, gt_obbs (B, K, 5) padded with gt_mask (B, K)."""
    anchors_xyxy = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2,
                              anchors[:, :2] + anchors[:, 2:] / 2], -1)
    labels, assigned = max_iou_assign(anchors_xyxy, obb_to_aabb(gt_obbs),
                                      gt_mask)
    cls_w, reg_w = sample_weights(labels, num_samples)
    cls_target = (labels == 1).float()
    bce = -(cls_target * F.logsigmoid(scores)
            + (1 - cls_target) * F.logsigmoid(-scores))
    targets = encode_midpoint_offset(
        anchors, torch.take_along_dim(gt_obbs, assigned[..., None], dim=1))
    reg = smooth_l1(deltas, targets).sum(-1)
    return {"rpn_cls": _weighted_mean(bce, cls_w),
            "rpn_reg": _weighted_mean(reg, reg_w)}


def roi_loss(cls_logits: torch.Tensor, reg: torch.Tensor,
             rois: torch.Tensor, gt_obbs: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor,
             num_classes: int, pos_thr: float = 0.5,
             num_samples: int = 128) -> Dict[str, torch.Tensor]:
    """Per-image RoI-head losses (B,): rois (B, R, 5) rotated proposals,
    cls_logits (B, R, C + 1) with background last, reg (B, R, 5)."""
    with torch.no_grad():  # decisions only
        iou = box_iou_rotated(rois, gt_obbs)           # (B, R, K)
        iou = torch.where(gt_mask[:, None, :], iou,
                          torch.full_like(iou, -1.0))
        best_iou, best_gt = iou.max(dim=-1).values, iou.argmax(dim=-1)
    labels01 = torch.where(best_iou >= pos_thr, 1,
                           torch.where(best_iou >= 0, 0, -1))
    cls_w, reg_w = sample_weights(labels01, num_samples, pos_fraction=0.25)
    cls_target = torch.where(
        labels01 == 1, torch.take_along_dim(gt_labels.long(), best_gt, dim=1),
        num_classes)
    logp = F.log_softmax(cls_logits.float(), -1)
    ce = -torch.take_along_dim(logp, cls_target[..., None], dim=-1)[..., 0]
    reg_targets = encode_obb_deltas(
        rois, torch.take_along_dim(gt_obbs, best_gt[..., None], dim=1))
    reg_l = smooth_l1(reg, reg_targets).sum(-1)
    return {"roi_cls": _weighted_mean(ce, cls_w),
            "roi_reg": _weighted_mean(reg_l, reg_w)}


def detection_loss(train_out: Dict[str, torch.Tensor], gt_obbs: torch.Tensor,
                   gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                   num_classes: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched Oriented R-CNN loss from OrientedRCNN's train-mode outputs:
    the four parts, each averaged over the images, and their sum.
    gt_obbs (B, K, 5), gt_labels (B, K), gt_mask (B, K)."""
    b, k = train_out["proposals"].shape[:2]
    rpn = rpn_loss(train_out["rpn_scores"].float(),
                   train_out["rpn_deltas"].float(), train_out["anchors"],
                   gt_obbs, gt_mask)
    rois = train_out["rois"].reshape(b, k, 6)[..., 1:]
    roi = roi_loss(train_out["roi_cls"], train_out["roi_reg"].float(), rois,
                   gt_obbs, gt_labels, gt_mask, num_classes)
    parts = {kk: v.mean() for kk, v in {**rpn, **roi}.items()}
    return sum(parts.values()), parts
