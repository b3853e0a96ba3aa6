"""COCO instance-segmentation data: JSON parsing, polygon and RLE masks,
fixed-shape batching for the fixed-shape Mask R-CNN; counterpart of
lemevit_tpu/data/coco.py (the reference's COCO config and mmdet's
CocoDataset), with no pycocotools: annotations parsed with the json
module, polygons rasterized by PIL.ImageDraw, uncompressed RLE decoded in
numpy. ``instance_collate`` gives CPU tensors for data/loader.py's
collate_fn.

Every image is resized with its aspect kept so that its longer side is
``img_size``, then padded at the bottom and right to a square; ground
truth is padded to ``max_boxes`` with a validity mask. Masks stay at the
padded image's full resolution, so that mask_rcnn_loss crops them with
the proposals in image coordinates.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def rasterize_polygons(polys: Sequence[Sequence[float]], h: int, w: int
                       ) -> np.ndarray:
    """COCO polygon segmentation -> (h, w) bool mask (PIL's rasterizer;
    polygons of fewer than three points are skipped)."""
    from PIL import Image, ImageDraw

    img = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        if len(poly) >= 6:
            draw.polygon([float(v) for v in poly], outline=1, fill=1)
    return np.asarray(img, bool)


def decode_rle(rle: Dict, h: int, w: int) -> np.ndarray:
    """Uncompressed COCO RLE ({'counts': [...], 'size': [h, w]}) -> (h, w)
    bool mask. The runs alternate 0s and 1s, 0s first, in column-major
    order."""
    counts = rle["counts"]
    if isinstance(counts, str):
        raise ValueError("compressed RLE not supported (needs pycocotools)")
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in counts:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    return flat.reshape(w, h).T


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """An annotation's segmentation (polygons or RLE) -> (h, w) bool."""
    seg = ann.get("segmentation")
    if isinstance(seg, list):
        return rasterize_polygons(seg, h, w)
    if isinstance(seg, dict):
        return decode_rle(seg, h, w)
    return np.zeros((h, w), bool)


class COCODataset:
    """COCO instances at a fixed square size: (image uint8 (S, S, 3),
    boxes xyxy (K, 4), contiguous labels (K,), masks bool (K, S, S)).
    The sparse category ids map to 0.. in id order; crowd annotations
    are skipped."""

    def __init__(self, root: str, split: str = "train2017",
                 ann_file: Optional[str] = None, img_size: int = 512,
                 transform: Optional[Callable] = None):
        self.img_dir = os.path.join(root, split)
        ann_file = ann_file or os.path.join(
            root, "annotations", f"instances_{split}.json")
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_size = img_size
        self.transform = transform
        cat_ids = sorted(c["id"] for c in coco["categories"])
        self.cat_to_label = {cid: i for i, cid in enumerate(cat_ids)}
        self.class_names = [c["name"] for c in sorted(
            coco["categories"], key=lambda c: c["id"])]
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_per_img: Dict[int, List[Dict]] = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            self.anns_per_img.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.images)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        from PIL import Image

        img_id = self.ids[i]
        info = self.images[img_id]
        img = Image.open(os.path.join(
            self.img_dir, info["file_name"])).convert("RGB")
        w0, h0 = img.size
        s = self.img_size
        scale = s / max(w0, h0)
        nw, nh = round(w0 * scale), round(h0 * scale)
        img = img.resize((nw, nh), Image.BILINEAR)
        canvas = np.zeros((s, s, 3), np.uint8)
        canvas[:nh, :nw] = np.asarray(img, np.uint8)

        boxes, labels, masks = [], [], []
        for ann in self.anns_per_img.get(img_id, []):
            x, y, bw, bh = ann["bbox"]
            boxes.append([x * scale, y * scale,
                          (x + bw) * scale, (y + bh) * scale])
            labels.append(self.cat_to_label[ann["category_id"]])
            m = ann_to_mask(ann, h0, w0)
            mimg = Image.fromarray(m.astype(np.uint8) * 255).resize(
                (nw, nh), Image.NEAREST)
            mc = np.zeros((s, s), bool)
            mc[:nh, :nw] = np.asarray(mimg) > 127
            masks.append(mc)
        boxes_a = (np.asarray(boxes, np.float32) if boxes
                   else np.zeros((0, 4), np.float32))
        labels_a = (np.asarray(labels, np.int32) if labels
                    else np.zeros((0,), np.int32))
        masks_a = np.stack(masks) if masks else np.zeros((0, s, s), bool)
        if self.transform:
            canvas, boxes_a, labels_a, masks_a = self.transform(
                canvas, boxes_a, labels_a, masks_a)
        return canvas, boxes_a, labels_a, masks_a


class SyntheticInstanceSeg:
    """Random rectangles with matching masks (smoke tests), one
    RandomState per index (the JAX package's samples)."""

    def __init__(self, n: int = 16, size: int = 128, num_classes: int = 4,
                 max_boxes: int = 3):
        self.n, self.size = n, size
        self.num_classes, self.max_boxes = num_classes, max_boxes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        s = self.size
        img = rng.randint(0, 256, (s, s, 3), np.uint8)
        k = rng.randint(1, self.max_boxes + 1)
        x0 = rng.uniform(4, s * 0.6, k)
        y0 = rng.uniform(4, s * 0.6, k)
        bw = rng.uniform(12, s * 0.3, k)
        bh = rng.uniform(12, s * 0.3, k)
        boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)
        labels = rng.randint(0, self.num_classes, k).astype(np.int32)
        masks = np.zeros((k, s, s), bool)
        for j, (a, b, c, d) in enumerate(boxes.astype(int)):
            masks[j, b:d, a:c] = True
        return img, boxes, labels, masks


def instance_collate(samples, max_boxes: int = 32
                     ) -> Dict[str, torch.Tensor]:
    """Pad per-image GT to max_boxes with a validity mask: CPU tensors
    {"image": uint8 (B, S, S, 3), "gt_boxes": float32 (B, K, 4),
    "gt_labels": int64 (B, K), "gt_masks": bool (B, K, S, S),
    "gt_valid": bool (B, K)}, K = max_boxes."""
    imgs, all_b, all_l, all_m = zip(*samples)
    b = len(imgs)
    s = all_m[0].shape[-1] if all_m[0].ndim == 3 else imgs[0].shape[0]
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    labels = np.zeros((b, max_boxes), np.int64)
    masks = np.zeros((b, max_boxes, s, s), bool)
    valid = np.zeros((b, max_boxes), bool)
    for i, (bx, lb, mk) in enumerate(zip(all_b, all_l, all_m)):
        k = min(len(bx), max_boxes)
        boxes[i, :k] = bx[:k]
        labels[i, :k] = lb[:k]
        if k:
            masks[i, :k] = mk[:k]
        valid[i, :k] = True
    return {"image": torch.from_numpy(np.stack(imgs)),
            "gt_boxes": torch.from_numpy(boxes),
            "gt_labels": torch.from_numpy(labels),
            "gt_masks": torch.from_numpy(masks),
            "gt_valid": torch.from_numpy(valid)}


def paste_masks(boxes: np.ndarray, masks: np.ndarray, out_hw: Tuple[int, int],
                labels: Optional[np.ndarray] = None,
                thr: float = 0.5) -> np.ndarray:
    """Paste per-RoI mask probabilities into the image frame: each mask
    resized (PIL bilinear, through uint8) to its box's whole-pixel
    extent, clipped to the image, and thresholded.

    boxes (K, 4) xyxy; masks (K, m, m), or (K, m, m, C) per class with
    ``labels`` choosing the channel. Returns (K, H, W) bool."""
    from PIL import Image

    h, w = out_hw
    k = len(boxes)
    out = np.zeros((k, h, w), bool)
    for i in range(k):
        m = masks[i]
        if m.ndim == 3:
            m = m[..., int(labels[i])]
        x0, y0, x1, y1 = boxes[i]
        x0i, y0i = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
        x1i, y1i = min(int(np.ceil(x1)), w), min(int(np.ceil(y1)), h)
        bw, bh = x1i - x0i, y1i - y0i
        if bw <= 0 or bh <= 0:
            continue
        mi = Image.fromarray((np.asarray(m, np.float32) * 255).astype(
            np.uint8)).resize((bw, bh), Image.BILINEAR)
        out[i, y0i:y1i, x0i:x1i] = np.asarray(mi, np.float32) / 255 > thr
    return out


__all__ = ["COCODataset", "SyntheticInstanceSeg", "instance_collate",
           "paste_masks", "rasterize_polygons", "decode_rle", "ann_to_mask"]
