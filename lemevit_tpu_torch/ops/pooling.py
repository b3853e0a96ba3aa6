"""Corner pooling and masked conv; counterpart of lemevit_tpu/ops/pooling.py
(the reference's corner_pool and masked_conv native ops).

corner_pool is a cumulative max along H or W, forward or reversed:
``torch.cummax`` on a flipped view gives the values. Its gradient follows
the JAX package's: ``lax.cummax`` is differentiated as an associative scan
of ``lax.max`` (a tree of pairwise maxima, each sending half the gradient
to either side of a tie), where ``torch.cummax`` would send all of it to
the one index it returns. The backward therefore differentiates the same
tree (``_scan_max``) built of ``torch.maximum``, whose gradient also
halves at ties. masked_conv2d is a dense convolution times the mask, as
in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_DIRECTIONS = {"top": (1, True), "bottom": (1, False),
               "left": (2, True), "right": (2, False)}


def _scan_max(x: torch.Tensor) -> torch.Tensor:
    """Forward cumulative max along dim 0 as JAX's associative_scan
    computes it: adjacent pairs combined, the half-length scan recursed,
    the even positions completed from it, the two interleaved."""
    n = x.shape[0]
    if n < 2:
        return x
    odd = _scan_max(torch.maximum(x[0:-1:2], x[1::2]))
    even = torch.maximum(odd[:-1] if n % 2 == 0 else odd, x[2::2])
    even = torch.cat([x[:1], even])
    k = odd.shape[0]
    out = torch.stack([even[:k], odd], dim=1).flatten(0, 1)
    return torch.cat([out, even[k:]])


class _CornerPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, reverse):
        ctx.axis, ctx.reverse = axis, reverse
        ctx.save_for_backward(x)
        t = x.flip(axis) if reverse else x
        out = torch.cummax(t, dim=axis).values
        return out.flip(axis) if reverse else out

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            t = xd.flip(ctx.axis) if ctx.reverse else xd
            out = _scan_max(t.movedim(ctx.axis, 0)).movedim(0, ctx.axis)
            if ctx.reverse:
                out = out.flip(ctx.axis)
            (gx,) = torch.autograd.grad(out, xd, g)
        return gx, None, None


def corner_pool(x: torch.Tensor, direction: str) -> torch.Tensor:
    """Directional max pooling on NHWC maps. 'top': each pixel takes the
    max over itself..bottom of its column (a reverse cumulative max along
    H); 'bottom': cumulative max along H; 'left': reverse along W; 'right':
    along W."""
    axis, reverse = _DIRECTIONS[direction]
    return _CornerPool.apply(x, axis, reverse)


def top_pool(x: torch.Tensor) -> torch.Tensor:
    return corner_pool(x, "top")


def bottom_pool(x: torch.Tensor) -> torch.Tensor:
    return corner_pool(x, "bottom")


def left_pool(x: torch.Tensor) -> torch.Tensor:
    return corner_pool(x, "left")


def right_pool(x: torch.Tensor) -> torch.Tensor:
    return corner_pool(x, "right")


def masked_conv2d(x: torch.Tensor, mask: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 1) -> torch.Tensor:
    """Conv evaluated at the masked output positions (zeros elsewhere).
    x: NHWC, mask: (N, H', W') or (N, H', W', 1) over *output* positions,
    kernel: HWIO."""
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                   stride=stride, padding=padding).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    if mask.ndim == 3:
        mask = mask[..., None]
    return out * mask.to(out.dtype)
