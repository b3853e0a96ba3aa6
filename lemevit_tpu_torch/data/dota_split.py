"""DOTA large-image tiling and detection merge (host-side, numpy); a
copy of lemevit_tpu/data/dota_split.py.

From-scratch equivalent of BboxToolkit's img_split + test-time merge used by
the reference's detection vertical (reference
object_detection/configs/obb/_base_/datasets/dota.py consumes
datasets/DOTA_1024/ tiles named {stem}__{rate}__{x0}___{y0}.png; scripts/
test_od.sh merges per-tile detections back to original-image submissions):

- split: slide size x size windows with `gap` overlap (stride = size - gap),
  clamp the last window to the image edge, shift GT polygons into tile
  coordinates and keep objects whose in-tile area fraction (IoF) clears
  `iof_thr` (partially-cut objects below it are dropped from that tile).
- merge: parse tile offsets back out of the filenames, shift per-tile
  detections to original coordinates, undo the scale rate, and run
  per-class rotated NMS across tiles to dedup the overlap strips.

Everything here is offline host code (data prep / submission formatting),
so it is plain numpy; the card never sees it.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from lemevit_tpu_torch.data.detection import parse_dota_annfile, poly_to_obb
from lemevit_tpu_torch.tasks.dota import DOTA10_CLASSES

TILE_RE = re.compile(r"^(?P<stem>.+)__(?P<rate>[\d.]+)__(?P<x>\d+)"
                     r"___(?P<y>\d+)$")


def tile_name(stem: str, x0: int, y0: int, rate: float = 1.0) -> str:
    r = int(rate) if float(rate).is_integer() else rate
    return f"{stem}__{r}__{x0}___{y0}"


def parse_tile_name(name: str) -> Tuple[str, float, int, int]:
    """'P0001__1__824___0' -> ('P0001', 1.0, 824, 0)."""
    m = TILE_RE.match(name)
    if not m:
        raise ValueError(f"not a tile name: {name!r}")
    return (m.group("stem"), float(m.group("rate")),
            int(m.group("x")), int(m.group("y")))


def iter_windows(w: int, h: int, size: int = 1024, gap: int = 200
                 ) -> List[Tuple[int, int]]:
    """Top-left corners of size x size sliding windows with `gap` overlap;
    the last window in each axis is clamped to end at the image edge."""
    stride = size - gap
    xs = list(range(0, max(w - size, 0) + 1, stride)) or [0]
    if xs[-1] + size < w:
        xs.append(w - size)
    ys = list(range(0, max(h - size, 0) + 1, stride)) or [0]
    if ys[-1] + size < h:
        ys.append(h - size)
    return [(x, y) for y in ys for x in xs]


def _clip_half_plane(pts: np.ndarray, a: np.ndarray, b: np.ndarray
                     ) -> np.ndarray:
    """Sutherland-Hodgman step: keep the side left of edge a->b."""
    if len(pts) == 0:
        return pts
    d = b - a
    side = d[0] * (pts[:, 1] - a[1]) - d[1] * (pts[:, 0] - a[0])
    out: List[np.ndarray] = []
    n = len(pts)
    for i in range(n):
        j = (i + 1) % n
        if side[i] >= 0:
            out.append(pts[i])
        if (side[i] >= 0) != (side[j] >= 0):
            t = side[i] / (side[i] - side[j])
            out.append(pts[i] + t * (pts[j] - pts[i]))
    return np.asarray(out) if out else np.zeros((0, 2))


def clip_poly(pts: np.ndarray, clipper: np.ndarray) -> np.ndarray:
    """Clip polygon `pts` (N,2) against a convex polygon `clipper` (either
    winding: reversed to CCW if its signed area is negative)."""
    x, y = clipper[:, 0], clipper[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    if signed < 0:
        clipper = clipper[::-1]
    out = pts
    m = len(clipper)
    for i in range(m):
        out = _clip_half_plane(out, clipper[i], clipper[(i + 1) % m])
        if len(out) == 0:
            break
    return out


def poly_area(pts: np.ndarray) -> float:
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1))
                           - np.dot(y, np.roll(x, -1))))


def _rect(x0: float, y0: float, x1: float, y1: float) -> np.ndarray:
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)


def split_image(img: np.ndarray, polys: np.ndarray, labels: np.ndarray,
                size: int = 1024, gap: int = 200, iof_thr: float = 0.7,
                keep_empty: bool = False, pad_value: int = 104
                ) -> List[Dict]:
    """Split one image + GT polys (K,8) into tiles.

    Returns dicts with keys: tile (size,size,3 u8), polys (K',8) in tile
    coords, labels (K',), x0, y0. Objects keep a tile when the fraction of
    their area inside it is >= iof_thr (BboxToolkit ann_type='iof'
    semantics); their polygons are NOT clipped (the coder handles
    out-of-tile extent), only shifted."""
    h, w = img.shape[:2]
    polys = polys.reshape(-1, 8).astype(np.float64)
    areas = np.array([poly_area(p.reshape(4, 2)) for p in polys])
    out = []
    for x0, y0 in iter_windows(w, h, size, gap):
        x1, y1 = min(x0 + size, w), min(y0 + size, h)
        rect = _rect(x0, y0, x1, y1)
        keep_idx = []
        for i, p in enumerate(polys):
            if areas[i] <= 0:
                continue
            clipped = clip_poly(p.reshape(4, 2), rect)
            if poly_area(clipped) / areas[i] >= iof_thr:
                keep_idx.append(i)
        if not keep_idx and not keep_empty:
            continue
        tile = np.full((size, size, img.shape[2]), pad_value, img.dtype)
        tile[:y1 - y0, :x1 - x0] = img[y0:y1, x0:x1]
        tp = polys[keep_idx].copy()
        tp[:, 0::2] -= x0
        tp[:, 1::2] -= y0
        out.append({"tile": tile, "polys": tp.astype(np.float32),
                    "labels": labels[keep_idx] if len(keep_idx)
                    else np.zeros((0,), np.int32),
                    "x0": x0, "y0": y0})
    return out


# ---- host-side rotated NMS for the merge step ----

def obb_to_poly_np(obbs: np.ndarray) -> np.ndarray:
    """(K,5) cx,cy,w,h,theta -> (K,4,2) corner polygons."""
    cx, cy, w, h, t = (obbs[:, i] for i in range(5))
    cos, sin = np.cos(t), np.sin(t)
    dx = np.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    dy = np.stack([h / 2, -h / 2, -h / 2, h / 2], -1)
    x = cx[:, None] + dx * cos[:, None] - dy * sin[:, None]
    y = cy[:, None] + dx * sin[:, None] + dy * cos[:, None]
    return np.stack([x, y], -1)


def nms_rotated_np(obbs: np.ndarray, scores: np.ndarray,
                   iou_thr: float = 0.1) -> np.ndarray:
    """Greedy rotated NMS (host). Returns kept indices, score-descending.
    AABB overlap prefilter keeps the exact polygon IoU O(n^2) loop cheap."""
    if len(obbs) == 0:
        return np.zeros((0,), np.int64)
    polys = obb_to_poly_np(obbs)
    areas = obbs[:, 2] * obbs[:, 3]
    lo = polys.min(1)
    hi = polys.max(1)
    order = np.argsort(-scores)
    keep: List[int] = []
    for i in order:
        ok = True
        for j in keep:
            if (lo[i] > hi[j]).any() or (lo[j] > hi[i]).any():
                continue  # disjoint AABBs -> IoU 0
            inter = poly_area(clip_poly(polys[i], polys[j]))
            iou = inter / max(areas[i] + areas[j] - inter, 1e-9)
            if iou > iou_thr:
                ok = False
                break
        if ok:
            keep.append(i)
    return np.asarray(keep, np.int64)


def merge_tile_detections(
        entries: Iterable[Tuple[str, np.ndarray, np.ndarray, np.ndarray]],
        iou_thr: float = 0.1,
        score_thr: float = 0.05) -> Dict[str, Dict[str, np.ndarray]]:
    """Merge per-tile detections back to original images.

    entries: iterable of (tile_name, boxes (K,5), scores (K,), labels (K,))
    — tile_name carries the offsets ({stem}__{rate}__{x}___{y}). Returns
    {stem: {"boxes", "scores", "labels"}} with coordinates in the original
    image frame and cross-tile duplicates removed by per-class rotated NMS."""
    per_img: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
    for name, boxes, scores, labels in entries:
        stem, rate, x0, y0 = parse_tile_name(name)
        sel = scores > score_thr
        if not sel.any():
            continue
        b = boxes[sel].astype(np.float64).copy()
        b[:, 0] = (b[:, 0] + x0) / rate
        b[:, 1] = (b[:, 1] + y0) / rate
        b[:, 2] /= rate
        b[:, 3] /= rate
        per_img.setdefault(stem, []).append(
            (b.astype(np.float32), scores[sel], labels[sel]))
    merged: Dict[str, Dict[str, np.ndarray]] = {}
    for stem, parts in per_img.items():
        boxes = np.concatenate([p[0] for p in parts])
        scores = np.concatenate([p[1] for p in parts])
        labels = np.concatenate([p[2] for p in parts])
        keep_all: List[int] = []
        for cls in np.unique(labels):
            idx = np.nonzero(labels == cls)[0]
            kept = nms_rotated_np(boxes[idx], scores[idx], iou_thr)
            keep_all.extend(idx[kept].tolist())
        keep_arr = np.asarray(sorted(keep_all), np.int64)
        merged[stem] = {"boxes": boxes[keep_arr],
                        "scores": scores[keep_arr],
                        "labels": labels[keep_arr]}
    return merged


def split_dataset(src: str, dst: str, split: str = "train",
                  size: int = 1024, gap: int = 200, iof_thr: float = 0.7,
                  class_names: Sequence[str] = DOTA10_CLASSES,
                  keep_empty: bool = False,
                  limit: Optional[int] = None) -> int:
    """Materialize a tiled dataset from original-size DOTA.

    src layout: {src}/{split}/images/*.png + {src}/{split}/annfiles/*.txt
    (labelTxt/ also accepted). dst gets the same layout with tile names.
    Returns the number of tiles written."""
    from PIL import Image

    img_dir = os.path.join(src, split, "images")
    ann_dir = os.path.join(src, split, "annfiles")
    if not os.path.isdir(ann_dir):
        ann_dir = os.path.join(src, split, "labelTxt")
    out_img = os.path.join(dst, split, "images")
    out_ann = os.path.join(dst, split, "annfiles")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_ann, exist_ok=True)
    names = sorted(os.listdir(img_dir))[:limit]
    n_tiles = 0
    for fname in names:
        stem, ext = os.path.splitext(fname)
        img = np.asarray(Image.open(
            os.path.join(img_dir, fname)).convert("RGB"))
        ann_path = os.path.join(ann_dir, stem + ".txt")
        if os.path.exists(ann_path):
            polys, labels = _parse_polys(ann_path, class_names)
        else:
            polys = np.zeros((0, 8), np.float32)
            labels = np.zeros((0,), np.int32)
        for t in split_image(img, polys, labels, size=size, gap=gap,
                             iof_thr=iof_thr, keep_empty=keep_empty):
            name = tile_name(stem, t["x0"], t["y0"])
            Image.fromarray(t["tile"]).save(
                os.path.join(out_img, name + ".png"))
            with open(os.path.join(out_ann, name + ".txt"), "w") as f:
                for p, lb in zip(t["polys"], t["labels"]):
                    coords = " ".join(f"{v:.1f}" for v in p)
                    f.write(f"{coords} {class_names[int(lb)]} 0\n")
            n_tiles += 1
    return n_tiles


class TiledDOTADataset:
    """Original-size DOTA images tiled on the fly (no materialized split).

    Indexes every (image, window) pair up front — image sizes come from the
    PIL header, no pixel decode — and decodes/crops per access. __getitem__
    returns (tile u8 HWC, obbs (K,5), labels (K,)) like
    detection.DOTADataset; `names[i]` carries the {stem}__{rate}__{x}___{y}
    tile id merge_tile_detections parses back."""

    def __init__(self, root: str, split: str = "train", size: int = 1024,
                 gap: int = 200, iof_thr: float = 0.7,
                 class_names: Sequence[str] = DOTA10_CLASSES,
                 keep_empty: bool = False):
        from PIL import Image

        self.img_dir = os.path.join(root, split, "images")
        ann = os.path.join(root, split, "annfiles")
        self.ann_dir = ann if os.path.isdir(ann) else os.path.join(
            root, split, "labelTxt")
        self.size, self.gap, self.iof_thr = size, gap, iof_thr
        self.class_names = class_names
        self.keep_empty = keep_empty
        self._ann_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.index: List[Tuple[str, int, int]] = []   # (fname, x0, y0)
        self.names: List[str] = []
        for fname in sorted(os.listdir(self.img_dir)):
            stem = os.path.splitext(fname)[0]
            with Image.open(os.path.join(self.img_dir, fname)) as im:
                w, h = im.size
            polys, labels = self._ann(stem)
            for x0, y0 in iter_windows(w, h, size, gap):
                if not keep_empty and len(polys):
                    # cheap precheck: any poly AABB touching the window?
                    px = polys[:, 0::2]
                    py = polys[:, 1::2]
                    hit = ((px.max(1) > x0) & (px.min(1) < x0 + size)
                           & (py.max(1) > y0) & (py.min(1) < y0 + size))
                    if not hit.any():
                        continue
                elif not keep_empty:
                    continue
                self.index.append((fname, x0, y0))
                self.names.append(tile_name(stem, x0, y0))

    def _ann(self, stem: str) -> Tuple[np.ndarray, np.ndarray]:
        if stem not in self._ann_cache:
            path = os.path.join(self.ann_dir, stem + ".txt")
            if os.path.exists(path):
                self._ann_cache[stem] = _parse_polys(path, self.class_names)
            else:
                self._ann_cache[stem] = (np.zeros((0, 8), np.float32),
                                         np.zeros((0,), np.int32))
        return self._ann_cache[stem]

    def original_gts(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Ground truth keyed by original image stem, as (K,5) obbs — the
        counterpart of merge_tile_detections for original-frame mAP."""
        out = {}
        for fname in sorted(os.listdir(self.img_dir)):
            stem = os.path.splitext(fname)[0]
            polys, labels = self._ann(stem)
            boxes = (np.stack([poly_to_obb(p) for p in polys])
                     if len(polys) else np.zeros((0, 5), np.float32))
            out[stem] = {"boxes": boxes, "labels": labels}
        return out

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        from PIL import Image

        fname, x0, y0 = self.index[i]
        stem = os.path.splitext(fname)[0]
        img = np.asarray(Image.open(
            os.path.join(self.img_dir, fname)).convert("RGB"), np.uint8)
        polys, labels = self._ann(stem)
        h, w = img.shape[:2]
        size = self.size
        x1, y1 = min(x0 + size, w), min(y0 + size, h)
        tile = np.full((size, size, 3), 104, np.uint8)
        tile[:y1 - y0, :x1 - x0] = img[y0:y1, x0:x1]
        rect = _rect(x0, y0, x1, y1)
        keep, obbs = [], []
        for j, p in enumerate(polys):
            quad = p.reshape(4, 2).astype(np.float64)
            a = poly_area(quad)
            if a <= 0:
                continue
            if poly_area(clip_poly(quad, rect)) / a >= self.iof_thr:
                shifted = p.copy()
                shifted[0::2] -= x0
                shifted[1::2] -= y0
                obbs.append(poly_to_obb(shifted))
                keep.append(j)
        obbs_arr = (np.stack(obbs).astype(np.float32) if obbs
                    else np.zeros((0, 5), np.float32))
        lab = labels[keep] if keep else np.zeros((0,), np.int32)
        return tile, obbs_arr, lab


def _parse_polys(path: str, class_names: Sequence[str]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Like parse_dota_annfile but keeps raw polygons (K,8)."""
    name_to_id = {n: i for i, n in enumerate(class_names)}
    polys, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 9 or parts[0].startswith(("imagesource", "gsd")):
                continue
            if parts[8] not in name_to_id:
                continue
            polys.append([float(v) for v in parts[:8]])
            labels.append(name_to_id[parts[8]])
    if not polys:
        return np.zeros((0, 8), np.float32), np.zeros((0,), np.int32)
    return (np.asarray(polys, np.float32),
            np.asarray(labels, np.int32))


__all__ = ["TiledDOTADataset",
           "iter_windows", "split_image", "split_dataset", "tile_name",
           "parse_tile_name", "merge_tile_detections", "nms_rotated_np",
           "obb_to_poly_np", "clip_poly", "poly_area", "poly_to_obb",
           "parse_dota_annfile"]
