"""Rotated-box geometry: IoU, NMS, polygon NMS, convex sort; counterpart
of lemevit_tpu/ops/rotated.py.

The geometry is the JAX package's fixed-size masked form: a convex quad
clipped by the 4 half-planes of another has at most 8 vertices, so every
polygon lives in an (8,)-vertex buffer with a count, and each clip step
emits (vertex, crossing) into 16 ordered slots that a stable compaction
moves to the front. Every pair of a call is one lane of the same tensors
(``_clip_lanes``): the polygon clipping of all the pairs of an (N, M)
block, of all images of a batch, runs as one set of elementwise launches
on the tensors' device, never a launch per pair or per box.

Boxes are (cx, cy, w, h, theta[rad]); polygons are (8,) flat xy quads.
``box_iou_rotated``, ``obb_nms`` and ``blocked_sup_matrix`` take leading
batch dimensions (JAX's ``vmap`` over images).
"""
from __future__ import annotations

import torch

from lemevit_tpu_torch.ops.boxes import sorted_keep

MAXV = 8  # max vertices of quad ∩ quad


def obb_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corner points (CCW for theta=0)."""
    cx, cy, w, h, t = boxes.unbind(-1)
    dx = torch.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    dy = torch.stack([-h / 2, h / 2, h / 2, -h / 2], -1)
    cos_t = torch.cos(t)[..., None]
    sin_t = torch.sin(t)[..., None]
    x = cx[..., None] + dx * cos_t - dy * sin_t
    y = cy[..., None] + dx * sin_t + dy * cos_t
    return torch.stack([x, y], -1)


def _ccw(qx: torch.Tensor, qy: torch.Tensor):
    """(4, P) vertex planes -> CCW-oriented (by the shoelace sign)."""
    s = (qx * torch.roll(qy, -1, 0) - torch.roll(qx, -1, 0) * qy).sum(0)
    flip = s < 0
    return (torch.where(flip, qx.flip(0), qx),
            torch.where(flip, qy.flip(0), qy))


def _wrap_next(t: torch.Tensor, cnt: torch.Tensor, kv: torch.Tensor
               ) -> torch.Tensor:
    """t[(k + 1) % cnt] for the active rows of t (8, P)."""
    t1 = torch.cat([t[1:], t[:1]], dim=0)
    return torch.where(kv == cnt[None, :] - 1, t[:1], t1)


def _clip_lanes(qax, qay, qbx, qby) -> torch.Tensor:
    """Intersection areas of P pairs of convex quads given as CCW vertex
    planes (4, P) each: Sutherland-Hodgman of quad a by the 4 edges of
    quad b in fixed (MAXV, P) buffers, the JAX package's
    _quad_inter_area_lanes step for step. The compaction puts slot j at
    row pos[j] by one scatter into a spare row (the JAX package's one-hot
    sum of exact zeros, the same values). Returns (P,)."""
    p = qax.shape[1]
    dev, dt = qax.device, qax.dtype
    kv = torch.arange(MAXV, device=dev)[:, None]              # (8, 1)
    pad = torch.zeros(MAXV - 4, p, device=dev, dtype=dt)
    px = torch.cat([qax, pad])
    py = torch.cat([qay, pad])
    cnt = torch.full((p,), 4, dtype=torch.int64, device=dev)
    for i in range(4):
        ax_, ay_ = qbx[i], qby[i]
        bx_, by_ = qbx[(i + 1) % 4], qby[(i + 1) % 4]
        ex, ey = bx_ - ax_, by_ - ay_
        s_cur = ex * (py - ay_) - ey * (px - ax_)             # (8, P)
        nx = _wrap_next(px, cnt, kv)
        ny = _wrap_next(py, cnt, kv)
        s_nxt = _wrap_next(s_cur, cnt, kv)
        in_cur = s_cur >= 0
        in_nxt = s_nxt >= 0
        denom = s_cur - s_nxt
        tiny = torch.where(denom < 0, -1e-12, 1e-12).to(dt)
        t = s_cur / torch.where(denom.abs() < 1e-12, tiny, denom)
        ix = px + t * (nx - px)
        iy = py + t * (ny - py)
        active = kv < cnt[None, :]
        # interleave (cur, intersection) into 16 ordered slots
        ex16_x = torch.stack([px, ix], dim=1).reshape(2 * MAXV, p)
        ex16_y = torch.stack([py, iy], dim=1).reshape(2 * MAXV, p)
        ok16 = torch.stack([active & in_cur, active & (in_cur ^ in_nxt)],
                           dim=1).reshape(2 * MAXV, p)
        pos = torch.cumsum(ok16, dim=0) - 1                   # (16, P)
        dst = torch.where(ok16 & (pos < MAXV), pos, MAXV)     # spare row 8
        px = torch.zeros(MAXV + 1, p, device=dev, dtype=dt).scatter(
            0, dst, ex16_x)[:MAXV]
        py = torch.zeros(MAXV + 1, p, device=dev, dtype=dt).scatter(
            0, dst, ex16_y)[:MAXV]
        cnt = ok16.sum(0).clamp(max=MAXV)
    nx = _wrap_next(px, cnt, kv)
    ny = _wrap_next(py, cnt, kv)
    cross = torch.where(kv < cnt[None, :], px * ny - nx * py,
                        torch.zeros_like(px))
    area = cross.sum(0).abs() / 2.0
    return torch.where(cnt >= 3, area, torch.zeros_like(area))


def _planes(q: torch.Tensor):
    """(P, 4, 2) quads -> CCW (4, P) x and y planes."""
    return _ccw(q[..., 0].T, q[..., 1].T)


def quad_intersection_area(q1: torch.Tensor, q2: torch.Tensor
                           ) -> torch.Tensor:
    """Intersection areas of convex quads paired elementwise: q1, q2
    (..., 4, 2) -> (...)."""
    shape = torch.broadcast_shapes(q1.shape, q2.shape)
    q1 = q1.expand(shape).reshape(-1, 4, 2)
    q2 = q2.expand(shape).reshape(-1, 4, 2)
    return _clip_lanes(*_planes(q1), *_planes(q2)).reshape(shape[:-2])


def _quad_inter_area_lanes(ca: torch.Tensor, cb: torch.Tensor
                           ) -> torch.Tensor:
    """All-pairs intersection areas: ca (..., N, 4, 2), cb (..., M, 4, 2)
    -> (..., N, M), every pair a lane."""
    return quad_intersection_area(ca[..., :, None, :, :],
                                  cb[..., None, :, :, :])


def box_iou_rotated(a: torch.Tensor, b: torch.Tensor, mode: str = "iou",
                    aligned: bool = False, eps: float = 1e-6
                    ) -> torch.Tensor:
    """Rotated IoU. a (..., N, 5), b (..., M, 5) -> (..., N, M);
    aligned=True -> (..., N) pairwise. mode 'iof' = intersection over
    a's area."""
    ca = obb_to_corners(a)
    cb = obb_to_corners(b)
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    if aligned:
        inter = quad_intersection_area(ca, cb)
        union = area_a if mode == "iof" else area_a + area_b - inter
        return inter / union.clamp(min=eps)
    inter = _quad_inter_area_lanes(ca, cb)
    if mode == "iof":
        union = area_a[..., :, None]
    else:
        union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=eps)


def obb_overlaps(a, b, mode: str = "iou", aligned: bool = False):
    """Alias matching the reference wrapper name."""
    return box_iou_rotated(a, b, mode=mode, aligned=aligned)


def obb_nms(boxes: torch.Tensor, scores: torch.Tensor,
            iou_threshold: float = 0.1, min_size: float = 1e-2
            ) -> torch.Tensor:
    """Greedy NMS on rotated boxes (..., N, 5). Tiny boxes (w or h under
    min_size) are dropped first (reference nms_rotated_wrapper.py:33-39).
    Returns the keep mask (..., N)."""
    big = (boxes[..., 2] >= min_size) & (boxes[..., 3] >= min_size)
    ranked = torch.where(big, scores, torch.full_like(scores, -torch.inf))
    return sorted_keep(boxes, ranked, big, box_iou_rotated, iou_threshold)


def _poly_area4(q: torch.Tensor) -> torch.Tensor:
    """Shoelace area of (..., 4, 2) quads."""
    x, y = q[..., 0], q[..., 1]
    cross = x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y
    return cross.sum(-1).abs() / 2.0


def poly_iou(p1: torch.Tensor, p2: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """IoU of convex quads given as flat (..., 8) xy polygons, paired
    elementwise."""
    q1 = p1.reshape(*p1.shape[:-1], 4, 2)
    q2 = p2.reshape(*p2.shape[:-1], 4, 2)
    inter = quad_intersection_area(q1, q2)
    return inter / (_poly_area4(q1) + _poly_area4(q2) - inter).clamp(min=eps)


def _pair_poly_iou(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    return poly_iou(pa[..., :, None, :], pb[..., None, :, :])


def poly_nms(polys: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.1) -> torch.Tensor:
    """Greedy NMS on flat (N, 8) convex quads. Returns the keep mask."""
    valid = torch.ones(scores.shape, dtype=torch.bool, device=polys.device)
    return sorted_keep(polys, scores, valid, _pair_poly_iou, iou_threshold)


def arb_batched_nms(boxes_or_polys: torch.Tensor, scores: torch.Tensor,
                    idxs: torch.Tensor, iou_threshold: float = 0.1
                    ) -> torch.Tensor:
    """Class-aware rotated / polygon NMS by the center-offset trick."""
    x = boxes_or_polys
    if x.shape[-1] == 5:
        span = x[:, :2].max() + x[:, 2:4].max() + 1
        off = idxs.to(x.dtype)[:, None] * span
        shifted = torch.cat([x[:, :2] + off, x[:, 2:]], dim=1)
        return obb_nms(shifted, scores, iou_threshold)
    span = x.max() + 1
    return poly_nms(x + idxs.to(x.dtype)[:, None] * span, scores,
                    iou_threshold)


def convex_sort(pts: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Sort candidate intersection points into convex-polygon (CCW) order
    around the centroid of the valid points; invalid points go last with
    index -1. pts (B, N, 2), masks (B, N) -> indices (B, N), int32."""
    m = masks.bool()
    n_valid = m.sum(-1, keepdim=True)
    centroid = ((pts * m[..., None]).sum(-2)
                / n_valid.clamp(min=1).to(pts.dtype))
    d = pts - centroid[..., None, :]
    ang = torch.atan2(d[..., 1], d[..., 0])
    key = torch.where(m, ang, torch.full_like(ang, torch.inf))
    order = torch.argsort(key, dim=-1, stable=True)
    idx = torch.arange(pts.shape[-2], device=pts.device)
    return torch.where(idx < n_valid, order,
                       torch.full_like(order, -1)).to(torch.int32)
