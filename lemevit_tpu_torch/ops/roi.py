"""RoI ops: roi_align (v1 and aligned / v2), roi_align_rotated, roi_pool,
multilevel_roi_align, point_sample; counterpart of lemevit_tpu/ops/roi.py.

Every sampler is the JAX package's gather with bilinear weights, formula
for formula (``_bilinear_gather``: its border rule, samples outside
(-1, H) x (-1, W) give zero, and its gradient with respect to the sample
coordinates through the clipped fractional parts), autograd giving the
backward (the gather's is a scatter-add). Feature maps are NHWC; rois
follow the mm conventions:
  roi_align:  (K, 5)  [batch_idx, x1, y1, x2, y2]   in image coords
  rotated:    (K, 6)  [batch_idx, cx, cy, w, h, theta(rad)]
Rois run in chunks of 256 under ``torch.utils.checkpoint`` when autograd
records (the JAX package's checkpointed lax.map): the backward recomputes
a chunk's four bilinear taps rather than keeping them, which at a
training batch of 8 x 256 proposals x 4 levels would be gigabytes.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _bilinear_gather(feat: torch.Tensor, bidx: torch.Tensor,
                     y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample feat (B, H, W, C) at float coords y / x (any shape S, with
    integer batch indices bidx of shape S). Out-of-range samples
    contribute zero (roi_align's border rule). Returns (S..., C)."""
    b, h, w, c = feat.shape
    valid = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y = y.clamp(0.0, h - 1)
    x = x.clamp(0.0, w - 1)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    ly = y - y0
    lx = x - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    flat = feat.reshape(b * h * w, c)

    def g(yy, xx):
        lin = (bidx * h + yy) * w + xx
        return flat[lin.reshape(-1)].reshape(*yy.shape, c)

    out = (g(y0, x0) * (hy * hx)[..., None] + g(y0, x1) * (hy * lx)[..., None]
           + g(y1, x0) * (ly * hx)[..., None]
           + g(y1, x1) * (ly * lx)[..., None])
    return out * valid[..., None]


# rois per checkpointed chunk: bounds the four live bilinear tap buffers
# (chunk, ph, pw, ns, ns, C)
_ROI_CHUNK = 256


def _roi_chunked(impl, rois: torch.Tensor, k_small: int = 256
                 ) -> torch.Tensor:
    """Run the per-roi sampler ``impl`` over roi chunks, each under
    checkpoint when autograd records, so the backward recomputes each
    chunk's gathers instead of storing them."""
    if rois.shape[0] <= k_small or not torch.is_grad_enabled():
        return impl(rois)
    return torch.cat([checkpoint(impl, r, use_reentrant=False)
                      for r in rois.split(_ROI_CHUNK)])


def _grid(n: int, ns: int, device) -> torch.Tensor:
    """(1, n, ns) sample offsets in bin units: bin + (s + 0.5) / ns."""
    return (torch.arange(n, device=device)[None, :, None]
            + (torch.arange(ns, device=device)[None, None, :] + 0.5) / ns)


def roi_align(feat: torch.Tensor, rois: torch.Tensor,
              output_size: Tuple[int, int], spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = False
              ) -> torch.Tensor:
    """RoI align on NHWC features. aligned=True is the v2 / detectron2
    half-pixel convention. Returns (K, ph, pw, C)."""
    return _roi_chunked(
        lambda r: _roi_align_impl(feat, r, output_size, spatial_scale,
                                  sampling_ratio, aligned), rois)


def _roi_align_impl(feat, rois, output_size, spatial_scale,
                    sampling_ratio, aligned):
    ph, pw = output_size
    ns = max(sampling_ratio, 1)
    offset = 0.5 if aligned else 0.0
    bidx = rois[:, 0].long()
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    rw = x2 - x1
    rh = y2 - y1
    if not aligned:  # v1 clamps degenerate rois to size 1
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    bin_h = rh / ph
    bin_w = rw / pw
    ys = y1[:, None, None] + _grid(ph, ns, feat.device) * bin_h[:, None, None]
    xs = x1[:, None, None] + _grid(pw, ns, feat.device) * bin_w[:, None, None]
    yy, xx = torch.broadcast_tensors(ys[:, :, None, :, None],
                                     xs[:, None, :, None, :])
    bb = bidx[:, None, None, None, None].expand(yy.shape)
    return _bilinear_gather(feat, bb, yy, xx).mean(dim=(3, 4))


def roi_align_rotated(feat: torch.Tensor, rois: torch.Tensor,
                      output_size: Tuple[int, int],
                      spatial_scale: float = 1.0, sampling_ratio: int = 2,
                      aligned: bool = True, clockwise: bool = False
                      ) -> torch.Tensor:
    """RoI align on rotated rois (batch_idx, cx, cy, w, h, theta): the
    axis-aligned sample grid rotated by theta around the roi center."""
    return _roi_chunked(
        lambda r: _roi_align_rotated_impl(feat, r, output_size,
                                          spatial_scale, sampling_ratio,
                                          aligned, clockwise), rois)


def _roi_align_rotated_impl(feat, rois, output_size, spatial_scale,
                            sampling_ratio, aligned, clockwise):
    ph, pw = output_size
    ns = max(sampling_ratio, 1)
    bidx = rois[:, 0].long()
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    rw = rois[:, 3] * spatial_scale
    rh = rois[:, 4] * spatial_scale
    theta = rois[:, 5]
    if clockwise:
        theta = -theta
    if aligned:  # half-pixel convention: image coord -> pixel-index coord
        cx = cx - 0.5
        cy = cy - 0.5
    bin_h = rh / ph
    bin_w = rw / pw
    # local coords centered on the roi
    ly = (_grid(ph, ns, feat.device) * bin_h[:, None, None]
          - rh[:, None, None] / 2)                           # (K, ph, ns)
    lx = (_grid(pw, ns, feat.device) * bin_w[:, None, None]
          - rw[:, None, None] / 2)                           # (K, pw, ns)
    lyy, lxx = torch.broadcast_tensors(ly[:, :, None, :, None],
                                       lx[:, None, :, None, :])
    cos_t = torch.cos(theta)[:, None, None, None, None]
    sin_t = torch.sin(theta)[:, None, None, None, None]
    gx = lxx * cos_t - lyy * sin_t + cx[:, None, None, None, None]
    gy = lxx * sin_t + lyy * cos_t + cy[:, None, None, None, None]
    bb = bidx[:, None, None, None, None].expand(gy.shape)
    return _bilinear_gather(feat, bb, gy, gx).mean(dim=(3, 4))


def roi_pool(feat: torch.Tensor, rois: torch.Tensor,
             output_size: Tuple[int, int], spatial_scale: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized max RoI pooling. Returns (out (K, ph, pw, C), argmax
    linear spatial indices (K, ph, pw, C), -1 for empty bins)."""
    ph, pw = output_size
    b, h, w, c = feat.shape
    dev = feat.device
    bidx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1] * spatial_scale).long()
    y1 = torch.round(rois[:, 2] * spatial_scale).long()
    x2 = torch.round(rois[:, 3] * spatial_scale).long()
    y2 = torch.round(rois[:, 4] * spatial_scale).long()
    rw = (x2 - x1 + 1).clamp(min=1)
    rh = (y2 - y1 + 1).clamp(min=1)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    outs, args = [], []
    for k in range(rois.shape[0]):
        # bin boundaries (ph + 1,), (pw + 1,)
        by = y1[k] + torch.div(torch.arange(ph + 1, device=dev) * rh[k], ph,
                               rounding_mode="floor")
        bx = x1[k] + torch.div(torch.arange(pw + 1, device=dev) * rw[k], pw,
                               rounding_mode="floor")
        in_y = ((ys[None, :] >= by[:-1, None].clamp(0, h))
                & (ys[None, :] < torch.maximum(by[1:, None], by[:-1, None] + 1
                                               ).clamp(0, h)))
        in_x = ((xs[None, :] >= bx[:-1, None].clamp(0, w))
                & (xs[None, :] < torch.maximum(bx[1:, None], bx[:-1, None] + 1
                                               ).clamp(0, w)))
        m = in_y[:, None, :, None] & in_x[None, :, None, :]  # (ph,pw,H,W)
        vals = torch.where(m[..., None], feat[bidx[k]][None, None],
                           torch.full((), -torch.inf, dtype=feat.dtype,
                                      device=dev))
        flat = vals.reshape(ph, pw, h * w, c)
        out, arg = flat.amax(dim=2), flat.argmax(dim=2)  # first on ties
        empty = ~m.any(dim=(2, 3))[..., None]
        outs.append(torch.where(empty, torch.zeros_like(out), out))
        args.append(torch.where(empty, torch.full_like(arg, -1), arg))
    if not outs:
        return (feat.new_zeros(0, ph, pw, c),
                torch.zeros(0, ph, pw, c, dtype=torch.long, device=dev))
    return torch.stack(outs), torch.stack(args)


def level_of(areas: torch.Tensor, n_levels: int,
             canonical_scale: float = 224.0) -> torch.Tensor:
    """FPN level per roi, l = floor(2 + log2(sqrt(area) / 224)) clipped to
    the pyramid (FPN paper eq. 1)."""
    lvl = torch.floor(torch.log2(torch.sqrt(areas) / canonical_scale
                                 + 1e-8)) + 2
    return lvl.clamp(0, n_levels - 1).long()


def multilevel_roi_align(pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                         output_size: Tuple[int, int], strides,
                         sampling_ratio: int = 2, aligned: bool = True,
                         canonical_scale: float = 224.0) -> torch.Tensor:
    """FPN-style multi-level RoI align with fixed shapes: every roi pooled
    from every level, the level of its area selected by a mask (the JAX
    package's form). rois (K, 5) [batch_idx, x1, y1, x2, y2]."""
    areas = ((rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2])
             ).clamp(min=1e-6)
    lvl = level_of(areas, len(pyramid), canonical_scale)
    out = None
    for i, (feat, s) in enumerate(zip(pyramid, strides)):
        pooled = roi_align(feat, rois, output_size, spatial_scale=1.0 / s,
                           sampling_ratio=sampling_ratio, aligned=aligned)
        sel = (lvl == i)[:, None, None, None].to(pooled.dtype)
        out = pooled * sel if out is None else out + pooled * sel
    return out


def point_sample(feat: torch.Tensor, points: torch.Tensor,
                 align_corners: bool = False) -> torch.Tensor:
    """grid_sample-style point sampling through the same gather. feat
    (B, H, W, C); points (B, P, 2) in [0, 1] (x, y) normalized coords.
    Returns (B, P, C)."""
    b, h, w, c = feat.shape
    x = points[..., 0]
    y = points[..., 1]
    if align_corners:
        gx = x * (w - 1)
        gy = y * (h - 1)
    else:
        gx = x * w - 0.5
        gy = y * h - 0.5
    bidx = torch.arange(b, device=feat.device)[:, None].expand(gx.shape)
    return _bilinear_gather(feat, bidx, gy, gx)
