"""Axis-aligned box ops: IoU, greedy NMS, soft-NMS, class-batched NMS;
counterpart of lemevit_tpu/ops/boxes.py.

Shapes stay fixed: a call returns a keep mask (or padded indices and a
count) over its inputs, never a tensor whose size depends on the data.
Greedy NMS is the JAX package's parallel fixpoint over the boolean
suppression matrix (``greedy_keep``): each pass is one (N, N) reduce and
one host check of "changed?", and a pass settles one more level of the
suppression chain, so a box set takes a handful of passes rather than N
dependent steps. Orders are taken with stable sorts, so that ties keep
the JAX package's order (``jnp.argsort`` is stable).

``greedy_keep`` and ``blocked_sup_matrix`` take leading batch dimensions
(one pass serves every image of a batch, as JAX's ``vmap`` does).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def greedy_keep(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy-NMS keep mask from a boolean suppression matrix in
    score-descending order: sup[..., i, j] says "box i overlaps box j
    beyond the threshold" (only i < j is used). Fixpoint of
        keep[j] = valid[j] & ~any_{i<j}(sup[i, j] & keep[i]),
    the sequential greedy result, reached in at most N passes (the JAX
    package's while_loop bound)."""
    n = sup.shape[-1]
    idx = torch.arange(n, device=sup.device)
    sup = sup & (idx[:, None] < idx[None, :])   # strict upper triangle
    keep = valid
    for _ in range(n):
        new = valid & ~(sup & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def blocked_sup_matrix(pairwise_fn: Callable, items: torch.Tensor,
                       thr: float, block: int = 512) -> torch.Tensor:
    """(..., N, N) boolean suppression matrix built in row blocks of
    ``block``, bounding the memory of pairwise geometry (rotated IoU keeps
    per-pair polygon scratch). ``items`` is (..., N, D) and
    ``pairwise_fn(rows, items)`` gives (..., rows, N)."""
    n = items.shape[-2]
    if n <= block:
        return pairwise_fn(items, items) > thr
    return torch.cat([pairwise_fn(items[..., s:s + block, :], items) > thr
                      for s in range(0, n, block)], dim=-2)


def box_iou(a: torch.Tensor, b: torch.Tensor, mode: str = "iou",
            eps: float = 1e-6) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: a (..., N, 4), b (..., M, 4) ->
    (..., N, M). mode 'iof' = intersection over the first (a) area."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    if mode == "iof":
        union = area_a[..., :, None]
    else:
        union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=eps)


def sorted_keep(items: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, pairwise_fn: Callable, thr: float
                ) -> torch.Tensor:
    """Greedy NMS over the last two dims of ``items`` (..., N, D): sort by
    score (stable, descending), build the suppression matrix in blocks
    (no autograd: it is boolean), settle the fixpoint, scatter the keep
    mask back to input order."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    it = torch.take_along_dim(items, order[..., None], dim=-2)
    with torch.no_grad():
        sup = blocked_sup_matrix(pairwise_fn, it, thr)
    keep_sorted = greedy_keep(sup, torch.take_along_dim(valid, order, -1))
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5,
        score_threshold: float = float("-inf")) -> torch.Tensor:
    """Greedy NMS. Returns a bool keep mask (N,) aligned with the inputs;
    boxes at or below score_threshold are never kept."""
    return sorted_keep(boxes, scores, scores > score_threshold, box_iou,
                       iou_threshold)


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.5,
                max_outputs: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS returning (padded indices sorted by score, valid count)."""
    k = max_outputs or boxes.shape[0]
    keep = nms(boxes, scores, iou_threshold)
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    idx = torch.argsort(-masked, stable=True)[:k]
    return idx, keep.sum().clamp(max=k)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.3, sigma: float = 0.5,
             method: str = "linear", score_threshold: float = 1e-3
             ) -> torch.Tensor:
    """Soft-NMS (linear / gaussian decay). Returns decayed scores (N,),
    zeroed below score_threshold. Each of the N rounds selects the running
    maximum among the boxes not yet selected (decay can reorder them) and
    decays the others, as the JAX package's fori_loop and the native
    library's leme_soft_nms."""
    n = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    s = scores.float().clone()
    remaining = torch.ones(n, dtype=torch.bool, device=boxes.device)
    neg = torch.full_like(s, -torch.inf)
    for _ in range(n):
        cur = torch.argmax(torch.where(remaining, s, neg))
        ov = iou[cur]
        if method == "gaussian":
            decay = torch.exp(-(ov ** 2) / sigma)
        else:
            decay = torch.where(ov > iou_threshold, 1.0 - ov,
                                torch.ones_like(ov))
        remaining[cur] = False
        # the selected box's score is frozen; only unselected boxes decay
        s = torch.where(remaining, s * decay, s)
    return torch.where(s >= score_threshold, s,
                       torch.zeros_like(s)).to(scores.dtype)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                idxs: torch.Tensor, iou_threshold: float = 0.5
                ) -> torch.Tensor:
    """Class-aware NMS by the coordinate-offset trick (boxes of different
    classes never overlap). Returns a keep mask (N,)."""
    max_coord = boxes.max() + 1.0
    shifted = boxes + idxs.to(boxes.dtype)[:, None] * max_coord
    return nms(shifted, scores, iou_threshold)


def nms_match(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.5) -> torch.Tensor:
    """For each box, the index of the kept box that suppressed it (itself
    if kept): among the kept boxes overlapping it beyond the threshold,
    the highest-scoring one."""
    n = boxes.shape[0]
    keep = nms(boxes, scores, iou_threshold)
    iou = box_iou(boxes, boxes)
    eye = torch.eye(n, dtype=torch.bool, device=boxes.device)
    cand = ((iou > iou_threshold) | eye) & keep[None, :]
    cand_scores = torch.where(cand, scores[None, :],
                              torch.full_like(iou, -torch.inf))
    return torch.argmax(cand_scores, dim=1)
