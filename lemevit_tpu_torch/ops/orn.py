"""Oriented Response Networks ops; counterpart of lemevit_tpu/ops/orn.py
(the reference's orn pack). ActiveRotatingFilter rotates conv filters
across n_rot discrete angles: a fixed permutation of the
(n_orient, k, k) filter cells, taken here as one gather whose backward
is a scatter-add. RotationInvariantEncoding is a max over the
orientation sub-axis of the channels. The index table is the port's own
copy of the JAX package's (numpy, cached per shape).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _arf_indices(kernel_size: int, n_orient: int, n_rot: int) -> np.ndarray:
    """indices[r, o, i, j] = (o', i', j'), the source cell of rotation r.

    Rotating a filter by angle a maps each spatial cell by the inverse
    rotation and shifts the orientation channels cyclically by
    r * n_orient / n_rot; the spatial rotation takes the nearest cell of
    the k x k grid (exact for multiples of 90 degrees)."""
    k = kernel_size
    out = np.zeros((n_rot, n_orient, k, k, 3), np.int32)
    c = (k - 1) / 2.0
    for r in range(n_rot):
        ang = 2 * np.pi * r / n_rot
        cos_a, sin_a = np.cos(ang), np.sin(ang)
        o_shift = r * n_orient // n_rot
        for o in range(n_orient):
            src_o = (o - o_shift) % n_orient
            for i in range(k):
                for j in range(k):
                    y, x = i - c, j - c
                    sx = cos_a * x + sin_a * y
                    sy = -sin_a * x + cos_a * y
                    si = min(max(int(round(sy + c)), 0), k - 1)
                    sj = min(max(int(round(sx + c)), 0), k - 1)
                    out[r, o, i, j] = (src_o, si, sj)
    return out


def active_rotating_filter(weight: torch.Tensor, n_rot: int = 8
                           ) -> torch.Tensor:
    """Rotated copies of an orientation-aware filter bank.

    weight: (Cout, Cin, n_orient, k, k). Returns (Cout * n_rot,
    Cin * n_orient, k, k): rotation r of output channel c at row
    c * n_rot + r (the ORN layout)."""
    cout, cin, n_orient, k, _ = weight.shape
    idx = torch.from_numpy(_arf_indices(k, n_orient, n_rot)).long().to(
        weight.device)
    rotated = weight[:, :, idx[..., 0], idx[..., 1], idx[..., 2]]
    rotated = rotated.transpose(1, 2)  # (Cout, R, Cin, O, k, k)
    return rotated.reshape(cout * n_rot, cin * n_orient, k, k)


def orconv2d(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None, stride: int = 1,
             padding: int = 1, n_rot: int = 8) -> torch.Tensor:
    """Oriented-response conv on NHWC input whose channels are
    (Cin * n_orient); weight (Cout, Cin, n_orient, k, k)."""
    w = active_rotating_filter(weight, n_rot)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride,
                   padding=padding).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.repeat_interleave(n_rot)
    return out


def rotation_invariant_encoding(x: torch.Tensor, n_orient: int
                                ) -> torch.Tensor:
    """Max over the orientation sub-axis: (..., C * n_orient) -> (..., C)."""
    return x.unflatten(-1, (x.shape[-1] // n_orient, n_orient)).amax(-1)


def rotation_invariant_pooling(x: torch.Tensor, n_orient: int = 8
                               ) -> torch.Tensor:
    """RIP: the orientation max over NHWC channels."""
    return rotation_invariant_encoding(x, n_orient)
