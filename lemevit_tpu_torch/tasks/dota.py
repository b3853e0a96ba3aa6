"""DOTA submission formatting (the reference's test_od --format-only output:
per-class Task1_{cls}.txt files with ``imgid score x1 y1 ... x4 y4`` lines);
a copy of lemevit_tpu/tasks/dota.py (numpy only).
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

DOTA10_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter")


def obb_to_poly_np(boxes: np.ndarray) -> np.ndarray:
    """(N,5) cx,cy,w,h,theta -> (N,8) corner polygons."""
    cx, cy, w, h, t = (boxes[:, i] for i in range(5))
    dx = np.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    dy = np.stack([-h / 2, h / 2, h / 2, -h / 2], -1)
    cos_t, sin_t = np.cos(t)[:, None], np.sin(t)[:, None]
    x = cx[:, None] + dx * cos_t - dy * sin_t
    y = cy[:, None] + dx * sin_t + dy * cos_t
    return np.stack([x, y], -1).reshape(len(boxes), 8)


def write_dota_submission(
        out_dir: str,
        detections: Dict[str, Dict[str, np.ndarray]],
        classes: Sequence[str] = DOTA10_CLASSES,
        score_thr: float = 0.05) -> List[str]:
    """detections: {image_id: {'boxes': (K,5), 'scores': (K,),
    'labels': (K,)}} -> Task1_{cls}.txt files. Returns written paths."""
    os.makedirs(out_dir, exist_ok=True)
    lines: Dict[int, List[str]] = {i: [] for i in range(len(classes))}
    for img_id, det in detections.items():
        boxes = np.asarray(det["boxes"], np.float64)
        scores = np.asarray(det["scores"], np.float64)
        labels = np.asarray(det["labels"], np.int64)
        keep = scores > score_thr
        polys = obb_to_poly_np(boxes[keep])
        for poly, s, l in zip(polys, scores[keep], labels[keep]):
            coords = " ".join(f"{v:.2f}" for v in poly)
            lines[int(l)].append(f"{img_id} {s:.4f} {coords}")
    paths = []
    for i, cls in enumerate(classes):
        path = os.path.join(out_dir, f"Task1_{cls}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines[i]) + ("\n" if lines[i] else ""))
        paths.append(path)
    return paths
