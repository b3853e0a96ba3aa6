"""mAP evaluation (VOC-style AP) for axis-aligned and rotated detections;
counterpart of lemevit_tpu/tasks/map_eval.py.

Host-side numpy evaluation (the reference delegates this to OBBDetection's
eval / the DOTA server). Rotated IoU goes through the port's ops/native.py:
its C++ library where it loads, else the port's torch op.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(det_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    if det_boxes.shape[-1] == 5:  # rotated
        from lemevit_tpu_torch.ops import native
        return native.box_iou_rotated(det_boxes, gt_boxes)
    lt = np.maximum(det_boxes[:, None, :2], gt_boxes[None, :, :2])
    rb = np.minimum(det_boxes[:, None, 2:], gt_boxes[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a = ((det_boxes[:, 2] - det_boxes[:, 0])
         * (det_boxes[:, 3] - det_boxes[:, 1]))[:, None]
    b = ((gt_boxes[:, 2] - gt_boxes[:, 0])
         * (gt_boxes[:, 3] - gt_boxes[:, 1]))[None, :]
    return inter / np.maximum(a + b - inter, 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      mode: str = "area") -> float:
    """all-point (area) or 11-point VOC AP."""
    if mode == "11points":
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def _mask_iou_matrix(det_masks: np.ndarray, gt_masks: np.ndarray
                     ) -> np.ndarray:
    """(Nd,H,W) x (Ng,H,W) bool -> (Nd,Ng) mask IoU."""
    d = det_masks.reshape(len(det_masks), -1).astype(np.float32)
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float32)
    inter = d @ g.T
    union = d.sum(1)[:, None] + g.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-9)


def evaluate_mask_map(detections: Dict[str, Dict[str, np.ndarray]],
                      ground_truths: Dict[str, Dict[str, np.ndarray]],
                      num_classes: int,
                      iou_thrs: Sequence[float] = tuple(
                          np.arange(0.5, 1.0, 0.05)),
                      mode: str = "area") -> Dict[str, float]:
    """Instance-segmentation mAP@[.5:.95] (COCO protocol) over binary
    masks. detections: {img: {'masks' (K,H,W) bool, 'scores', 'labels'}};
    ground_truths: {img: {'masks', 'labels'}}. Returns
    {'mask_mAP', 'mask_AP50', 'mask_AP75'}."""
    per_thr = []
    for thr in iou_thrs:
        aps = {}
        for cls in range(num_classes):
            records: List = []
            n_gt = 0
            for img_id, gt in ground_truths.items():
                gsel = np.asarray(gt["labels"]) == cls
                g_masks = np.asarray(gt["masks"], bool)[gsel]
                n_gt += len(g_masks)
                det = detections.get(img_id)
                if det is None:
                    continue
                dsel = np.asarray(det["labels"]) == cls
                d_masks = np.asarray(det["masks"], bool)[dsel]
                d_scores = np.asarray(det["scores"], np.float32)[dsel]
                order = np.argsort(-d_scores)
                d_masks, d_scores = d_masks[order], d_scores[order]
                matched = np.zeros(len(g_masks), bool)
                if len(g_masks) and len(d_masks):
                    iou = _mask_iou_matrix(d_masks, g_masks)
                for i in range(len(d_masks)):
                    tp = False
                    if len(g_masks):
                        j = int(iou[i].argmax())
                        if iou[i, j] >= thr and not matched[j]:
                            matched[j] = True
                            tp = True
                    records.append((float(d_scores[i]), tp))
            if n_gt == 0:
                continue
            records.sort(key=lambda r: -r[0])
            tps = np.array([r[1] for r in records], np.float64)
            if len(tps) == 0:
                aps[cls] = 0.0
                continue
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1.0 - tps)
            aps[cls] = average_precision(
                tp_cum / n_gt, tp_cum / np.maximum(tp_cum + fp_cum, 1e-9),
                mode)
        per_thr.append(float(np.mean(list(aps.values()))) if aps else 0.0)
    out = {"mask_mAP": float(np.mean(per_thr)) if per_thr else 0.0}
    thrs = [round(float(t), 2) for t in iou_thrs]
    if 0.5 in thrs:
        out["mask_AP50"] = per_thr[thrs.index(0.5)]
    if 0.75 in thrs:
        out["mask_AP75"] = per_thr[thrs.index(0.75)]
    return out


def evaluate_map(detections: Dict[str, Dict[str, np.ndarray]],
                 ground_truths: Dict[str, Dict[str, np.ndarray]],
                 num_classes: int, iou_thr: float = 0.5,
                 mode: str = "area") -> Dict[str, float]:
    """detections / ground_truths: {image_id: {'boxes': (K,4|5),
    'scores' (dets only), 'labels'}}. Returns {'mAP':..., 'AP_c':...}."""
    aps = {}
    for cls in range(num_classes):
        records: List = []   # (score, is_tp)
        n_gt = 0
        for img_id, gt in ground_truths.items():
            gt_mask = np.asarray(gt["labels"]) == cls
            gt_boxes = np.asarray(gt["boxes"], np.float32)[gt_mask]
            n_gt += len(gt_boxes)
            det = detections.get(img_id)
            if det is None:
                continue
            d_mask = np.asarray(det["labels"]) == cls
            d_boxes = np.asarray(det["boxes"], np.float32)[d_mask]
            d_scores = np.asarray(det["scores"], np.float32)[d_mask]
            order = np.argsort(-d_scores)
            d_boxes, d_scores = d_boxes[order], d_scores[order]
            matched = np.zeros(len(gt_boxes), bool)
            if len(gt_boxes) and len(d_boxes):
                iou = _iou_matrix(d_boxes, gt_boxes)
            for i in range(len(d_boxes)):
                tp = False
                if len(gt_boxes):
                    j = int(iou[i].argmax())
                    if iou[i, j] >= iou_thr and not matched[j]:
                        matched[j] = True
                        tp = True
                records.append((float(d_scores[i]), tp))
        if n_gt == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.array([r[1] for r in records], np.float64)
        if len(tps) == 0:
            aps[cls] = 0.0
            continue
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(1.0 - tps)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        aps[cls] = average_precision(recall, precision, mode)
    out = {f"AP_{c}": v for c, v in aps.items()}
    out["mAP"] = float(np.mean(list(aps.values()))) if aps else 0.0
    return out
