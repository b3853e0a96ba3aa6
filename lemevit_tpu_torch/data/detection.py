"""Detection datasets: DOTA-format annotations + padded-GT batching;
counterpart of lemevit_tpu/data/detection.py (numpy and PIL), whose
``detection_collate`` gives CPU tensors for data/loader.py's collate_fn.

DOTA layout (the reference's object-detection data, prepared by
BboxToolkit's img_split into 1024^2 tiles):
  {root}/{split}/images/P0001__1__0___0.png
  {root}/{split}/annfiles/P0001__1__0___0.txt   # per line:
      x1 y1 x2 y2 x3 y3 x4 y4 class difficulty

Polygons are converted to (cx, cy, w, h, theta) oriented boxes analytically
(no OpenCV): for the near-rectangular DOTA polys, the edge midpoint frame
recovers the canonical rotated box. GT arrays are padded to max_boxes with
a validity mask (fixed shapes for the batched loss).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lemevit_tpu_torch.tasks.dota import DOTA10_CLASSES


def poly_to_obb(poly: np.ndarray) -> np.ndarray:
    """(8,) quad -> (5,) cx,cy,w,h,theta. Assumes a (near-)rectangle in
    vertex order; uses opposite-edge midpoints for a robust frame."""
    p = poly.reshape(4, 2).astype(np.float64)
    cx, cy = p.mean(0)
    # opposite-edge midpoints span the box axes for sequentially-ordered
    # rectangle vertices (edge 0-1 vs 2-3, edge 1-2 vs 3-0)
    v_w = (p[0] + p[1]) / 2 - (p[2] + p[3]) / 2
    v_h = (p[1] + p[2]) / 2 - (p[3] + p[0]) / 2
    w = float(np.linalg.norm(v_w))
    h = float(np.linalg.norm(v_h))
    theta = float(np.arctan2(v_w[1], v_w[0]))
    # canonicalize to theta in (-pi/4, pi/4] (unique up to w/h swap)
    theta = (theta + np.pi / 2) % np.pi - np.pi / 2
    if theta > np.pi / 4:
        w, h = h, w
        theta -= np.pi / 2
    elif theta <= -np.pi / 4:
        w, h = h, w
        theta += np.pi / 2
    return np.array([cx, cy, w, h, theta], np.float32)


def parse_dota_annfile(path: str,
                       class_names: Sequence[str] = DOTA10_CLASSES,
                       skip_difficult: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (obbs (K,5), labels (K,))."""
    name_to_id = {n: i for i, n in enumerate(class_names)}
    obbs, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 9 or parts[0].startswith(("imagesource",
                                                      "gsd")):
                continue
            cls = parts[8]
            if cls not in name_to_id:
                continue
            if skip_difficult and len(parts) > 9 and parts[9] == "1":
                continue
            poly = np.array([float(v) for v in parts[:8]], np.float32)
            obbs.append(poly_to_obb(poly))
            labels.append(name_to_id[cls])
    if not obbs:
        return np.zeros((0, 5), np.float32), np.zeros((0,), np.int32)
    return np.stack(obbs), np.asarray(labels, np.int32)


class DOTADataset:
    """images/ + annfiles/ tiles; returns (img u8 HWC, obbs, labels)."""

    def __init__(self, root: str, split: str = "train",
                 class_names: Sequence[str] = DOTA10_CLASSES,
                 transform: Optional[Callable] = None):
        from PIL import Image  # noqa: F401
        self.img_dir = os.path.join(root, split, "images")
        self.ann_dir = os.path.join(root, split, "annfiles")
        self.names = sorted(os.listdir(self.img_dir))
        self.class_names = class_names
        self.transform = transform

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        from PIL import Image
        name = self.names[i]
        img = np.asarray(Image.open(
            os.path.join(self.img_dir, name)).convert("RGB"), np.uint8)
        stem = os.path.splitext(name)[0]
        obbs, labels = parse_dota_annfile(
            os.path.join(self.ann_dir, stem + ".txt"), self.class_names)
        if self.transform:
            img, obbs, labels = self.transform(img, obbs, labels)
        return img, obbs, labels


class SyntheticDetection:
    """Random boxes on random images (smoke tests / benchmarks)."""

    def __init__(self, n: int = 64, size: int = 256, num_classes: int = 15,
                 max_boxes: int = 4):
        self.n, self.size = n, size
        self.num_classes, self.max_boxes = num_classes, max_boxes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        img = rng.randint(0, 256, (self.size, self.size, 3), np.uint8)
        k = rng.randint(1, self.max_boxes + 1)
        cx = rng.uniform(40, self.size - 40, k)
        cy = rng.uniform(40, self.size - 40, k)
        w = rng.uniform(16, 60, k)
        h = rng.uniform(16, 60, k)
        t = rng.uniform(-1.2, 1.2, k)
        obbs = np.stack([cx, cy, w, h, t], -1).astype(np.float32)
        labels = rng.randint(0, self.num_classes, k).astype(np.int32)
        return img, obbs, labels


def detection_collate(samples, max_boxes: int = 64
                      ) -> Dict[str, torch.Tensor]:
    """Pad per-image GT to max_boxes with a validity mask: CPU tensors
    {"image": uint8 (B, H, W, 3), "gt_obbs": float32 (B, K, 5),
    "gt_labels": int64 (B, K), "gt_mask": bool (B, K)}, K = max_boxes."""
    imgs, all_obbs, all_labels = zip(*samples)
    b = len(imgs)
    obbs = np.zeros((b, max_boxes, 5), np.float32)
    labels = np.zeros((b, max_boxes), np.int32)
    mask = np.zeros((b, max_boxes), bool)
    for i, (o, l) in enumerate(zip(all_obbs, all_labels)):
        k = min(len(o), max_boxes)
        obbs[i, :k] = o[:k]
        labels[i, :k] = l[:k]
        mask[i, :k] = True
    return {"image": torch.from_numpy(np.stack(imgs)),
            "gt_obbs": torch.from_numpy(obbs),
            "gt_labels": torch.from_numpy(labels.astype(np.int64)),
            "gt_mask": torch.from_numpy(mask)}
