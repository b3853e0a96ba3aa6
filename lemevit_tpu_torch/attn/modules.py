"""Attention modules of LeMeViT, as the plain PyTorch composition.

Four forms, keyed by a stage's ``attn_type``:
  "S"  StandardAttention     fused-QKV self-attention, scale head_dim**-0.5
  "C"  CrossAttention        q from c, k/v from the image tokens; new c only
  "D"  DualCrossAttention    qkv1 from x, qkv2 from c; x <- attn(q1, k2, v2)
                             with scale_x, c <- attn(q2, k1, v1) with scale_c
  "D2" DualCrossAttentionV2  q, v1 from x; k, v2 from c; x <- attn(q, k, v2),
                             c <- attn(k, q, v1)
Layout (B, N, H, d) throughout. Counterpart of lemevit_tpu/attn/modules.py.

Kernels: a whole pre-norm block runs as hand-written kernels
(``attn/fused_block.py`` in inference, ``attn/fused_train.py`` in
training), chosen by ``use_kernel`` and the JAX package's token-count
limits; these modules are the composition a block runs otherwise
(post-norm, layer-scale, above those limits, on CPU tensors under "auto",
or ``attn_backend="torch"``). The JAX package's attention-only kernels
(pallas_dca.dca, pallas_mhsa.mhsa) have no port yet, so the modules always
compose.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from lemevit_tpu_torch.attn import reference as ref

BACKENDS = ("auto", "torch", "cuda")


def use_kernel(backend: str, t: torch.Tensor) -> bool:
    """Whether a block runs its fused kernel for tensor ``t``.

    "auto": the kernel for CUDA tensors, the composition for CPU tensors;
    "torch": always the composition; "cuda": the kernel, raising for a CPU
    tensor."""
    if backend == "torch":
        return False
    if backend == "auto":
        return t.is_cuda
    if backend == "cuda":
        if not t.is_cuda:
            raise RuntimeError("attn_backend='cuda' runs the CUDA kernels and "
                               f"needs CUDA tensors, got one on {t.device}")
        return True
    raise ValueError(f"attn_backend must be one of {BACKENDS}, got {backend!r}")


class StandardAttention(nn.Module):
    """Fused-QKV multi-head self-attention."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        r = self.qkv(x).view(b, n, 3, h, c // h)
        out = ref.sdpa_bnhd(r[:, :, 0], r[:, :, 1], r[:, :, 2])
        return self.proj(out.reshape(b, n, c))


class CrossAttention(nn.Module):
    """Meta-token initialiser: c attends to the image tokens."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, c):
        b, n, ch = x.shape
        m = c.shape[1]
        h = self.num_heads
        q = self.q(c).view(b, m, h, ch // h)
        kv = self.kv(x).view(b, n, 2, h, ch // h)
        out = ref.sdpa_bnhd(q, kv[:, :, 0], kv[:, :, 1])
        return self.proj(out.reshape(b, m, ch))


class DualCrossAttention(nn.Module):
    """DCA: image and meta tokens swap query and key/value roles, with the
    full-embed-dim scales of reference.dca_scales."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv1 = nn.Linear(dim, 3 * dim)
        self.qkv2 = nn.Linear(dim, 3 * dim)
        self.proj_x = nn.Linear(dim, dim)
        self.proj_c = nn.Linear(dim, dim)

    def forward(self, x, c):
        b, n, ch = x.shape
        m = c.shape[1]
        h = self.num_heads
        scale_x, scale_c = ref.dca_scales(n, m, ch)
        r1 = self.qkv1(x).view(b, n, 3, h, ch // h)
        r2 = self.qkv2(c).view(b, m, 3, h, ch // h)
        x_out = ref.sdpa_bnhd(r1[:, :, 0], r2[:, :, 1], r2[:, :, 2],
                              scale=scale_x).reshape(b, n, ch)
        c_out = ref.sdpa_bnhd(r2[:, :, 0], r1[:, :, 1], r1[:, :, 2],
                              scale=scale_c).reshape(b, m, ch)
        return self.proj_x(x_out), self.proj_c(c_out)


class DualCrossAttentionV2(nn.Module):
    """Cheaper DCA: q and v1 from x, k and v2 from c; q and k serve both
    directions."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qv1 = nn.Linear(dim, 2 * dim)
        self.kv2 = nn.Linear(dim, 2 * dim)
        self.proj_x = nn.Linear(dim, dim)
        self.proj_c = nn.Linear(dim, dim)

    def forward(self, x, c):
        b, n, ch = x.shape
        m = c.shape[1]
        h = self.num_heads
        scale_x, scale_c = ref.dca_scales(n, m, ch)
        r1 = self.qv1(x).view(b, n, 2, h, ch // h)
        r2 = self.kv2(c).view(b, m, 2, h, ch // h)
        q, v1 = r1[:, :, 0], r1[:, :, 1]
        k, v2 = r2[:, :, 0], r2[:, :, 1]
        x_out = ref.sdpa_bnhd(q, k, v2, scale=scale_x).reshape(b, n, ch)
        c_out = ref.sdpa_bnhd(k, q, v1, scale=scale_c).reshape(b, m, ch)
        return self.proj_x(x_out), self.proj_c(c_out)
