"""Plain PyTorch attention: the numerics the fused kernels are held to.

Softmax runs in float32 whatever the input type; the output is cast back to
the input type. Layout (B, N, H, d), as in the JAX package.

Scales:
  - self / cross attention: head_dim ** -0.5;
  - dual cross-attention uses the *full embed dim*, asymmetrically:
      scale_x = log_N(M) * C ** -0.5,  scale_c = C ** -0.5,
    with N image tokens, M meta tokens and embed dim C.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# Above this many scores per (image, head) the query axis is chunked, so the
# float32 score tensor never exists whole.
CHUNK_SCORES = 4 * 1024 * 1024


def dca_scales(n_tokens: int, m_tokens: int, dim: int) -> tuple:
    """(scale_x, scale_c) of dual cross-attention: image tokens attend to
    meta tokens with log_N(M) * C**-0.5, meta tokens to image tokens with
    C**-0.5."""
    base = dim ** -0.5
    return math.log(m_tokens, n_tokens) * base, base


def sdpa_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention on (B, N, H, d) tensors with a float32 softmax."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    if q.shape[1] * k.shape[1] > CHUNK_SCORES:
        return sdpa_bnhd_chunked(q, k, v, scale)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def sdpa_bnhd_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float] = None,
                      target_bytes: int = 1 << 30) -> torch.Tensor:
    """sdpa_bnhd over query chunks sized so one chunk's float32 scores take
    about ``target_bytes``; every chunk sees all keys, so the result is the
    same as the one-shot form."""
    b, n, h, d = q.shape
    m = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    chunk = max(64, min(n, target_bytes // max(1, b * h * m * 4)))
    chunk = 1 << (chunk.bit_length() - 1)
    outs = []
    for s in range(0, n, chunk):
        qi = q[:, s:s + chunk]
        logits = torch.einsum("bnhd,bmhd->bhnm", qi.float(), k.float()) * scale
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype), v))
    return torch.cat(outs, dim=1).to(q.dtype)
