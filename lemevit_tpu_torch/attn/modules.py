"""Attention modules of LeMeViT: counterpart of lemevit_tpu/attn/modules.py.

Four forms, keyed by a stage's ``attn_type``:
  "S"  StandardAttention     fused-QKV self-attention, scale head_dim**-0.5
  "C"  CrossAttention        q from c, k/v from the image tokens; new c only
  "D"  DualCrossAttention    qkv1 from x, qkv2 from c; x <- attn(q1, k2, v2)
                             with scale_x, c <- attn(q2, k1, v1) with scale_c
  "D2" DualCrossAttentionV2  q, v1 from x; k, v2 from c; x <- attn(q, k, v2),
                             c <- attn(k, q, v1)
Layout (B, N, H, d) throughout.

Kernels: a whole pre-norm block runs as hand-written kernels
(``attn/fused_block.py`` in inference, ``attn/fused_train.py`` in
training), chosen by the block (``use_kernel`` and the JAX package's
token-count limits). A block that does not (post-norm, layer-scale, above
those limits: segmentation at 512^2) runs these modules, and each module
hands its attention to an attention-only kernel where ``use_kernel(
attn_backend, x)`` holds, at the places the JAX package calls its Pallas
kernels:
  StandardAttention     mhsa.mhsa (lemevit_tpu/attn/modules.py:79-82)
  CrossAttention        mhsa.sdpa (:55-62, :106), which declines cross shapes
  DualCrossAttention    dca.dca(q1, k1, v1, q2, k2, v2) (:133-140)
  DualCrossAttentionV2  dca.dca(q, q, v1, k, k, v2) (:178-187)
Where the kernel function declines (returns None, under the JAX package's
conditions) the module composes ``reference.sdpa_bnhd``; so it does for CPU
tensors under "auto" and always under "torch". Under "auto" a module on
the card also composes where its kernel's own limits say no
(``mhsa.kernel_takes``, ``dca.kernel_takes``: head_dim 32, fp32 or bf16,
at most ``MAX_META`` meta tokens; ``shapes_ok``), decided from shapes
before any launch, as the JAX package's kernels decline; under "cuda" the
kernel is called and raises for them.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from lemevit_tpu_torch.attn import dca as dca_mod
from lemevit_tpu_torch.attn import mhsa as mhsa_mod
from lemevit_tpu_torch.attn import reference as ref

BACKENDS = ("auto", "torch", "cuda")


def on_card(t: torch.Tensor) -> bool:
    """Whether a kernel path for tensor ``t`` launches CUDA kernels (for a
    CPU tensor it runs their plain versions, which take any shape)."""
    return t.is_cuda


def shapes_ok(backend: str, t: torch.Tensor, takes: bool) -> bool:
    """Whether a kernel path may take tensor ``t``'s shapes, ``takes`` being
    its kernel's own shape predicate: under "auto" a tensor on the card
    needs it (where it says no the caller composes, as the JAX package does
    where its kernels return None); "cuda" calls the kernel, which raises
    for what it does not take; CPU tensors run the plain versions."""
    return backend == "cuda" or not on_card(t) or takes


def use_kernel(backend: str, t: torch.Tensor) -> bool:
    """Whether a block or an attention module runs its kernel for tensor
    ``t``.

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


class _Attention(nn.Module):
    """Base of the four forms: heads and the kernel switch."""

    def __init__(self, num_heads: int, attn_backend: str):
        super().__init__()
        if attn_backend not in BACKENDS:
            raise ValueError(f"attn_backend must be one of {BACKENDS}")
        self.num_heads = num_heads
        self.attn_backend = attn_backend


class StandardAttention(_Attention):
    """Fused-QKV multi-head self-attention."""

    def __init__(self, dim: int, num_heads: int, attn_backend: str = "auto"):
        super().__init__(num_heads, attn_backend)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        out = None
        if use_kernel(self.attn_backend, x) and shapes_ok(
                self.attn_backend, x, mhsa_mod.kernel_takes(c, h, qkv.dtype)):
            out = mhsa_mod.mhsa(*qkv.split(c, dim=-1), num_heads=h)
        if out is None:
            r = qkv.view(b, n, 3, h, c // h)
            out = ref.sdpa_bnhd(r[:, :, 0], r[:, :, 1],
                                r[:, :, 2]).reshape(b, n, c)
        return self.proj(out)


class CrossAttention(_Attention):
    """Meta-token initialiser: c attends to the image tokens."""

    def __init__(self, dim: int, num_heads: int, attn_backend: str = "auto"):
        super().__init__(num_heads, attn_backend)
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, c):
        b, n, ch = x.shape
        m = c.shape[1]
        h = self.num_heads
        q = self.q(c).view(b, m, h, ch // h)
        kv = self.kv(x).view(b, n, 2, h, ch // h)
        out = None
        if use_kernel(self.attn_backend, x) and shapes_ok(
                self.attn_backend, x, mhsa_mod.kernel_takes(ch, h, q.dtype)):
            out = mhsa_mod.sdpa(q, kv[:, :, 0], kv[:, :, 1])
        if out is None:
            out = ref.sdpa_bnhd(q, kv[:, :, 0], kv[:, :, 1])
        return self.proj(out.reshape(b, m, ch))


class DualCrossAttention(_Attention):
    """DCA: image and meta tokens swap query and key/value roles, with the
    full-embed-dim scales of reference.dca_scales."""

    def __init__(self, dim: int, num_heads: int, attn_backend: str = "auto"):
        super().__init__(num_heads, attn_backend)
        self.qkv1 = nn.Linear(dim, 3 * dim)
        self.qkv2 = nn.Linear(dim, 3 * dim)
        self.proj_x = nn.Linear(dim, dim)
        self.proj_c = nn.Linear(dim, dim)

    def forward(self, x, c):
        b, n, ch = x.shape
        m = c.shape[1]
        h = self.num_heads
        scale_x, scale_c = ref.dca_scales(n, m, ch)
        qkv1, qkv2 = self.qkv1(x), self.qkv2(c)
        pair = None
        if use_kernel(self.attn_backend, x) and shapes_ok(
                self.attn_backend, x,
                dca_mod.kernel_takes(ch, h, m, qkv1.dtype)):
            pair = dca_mod.dca(*qkv1.split(ch, dim=-1),
                               *qkv2.split(ch, dim=-1), scale_x=scale_x,
                               scale_c=scale_c, num_heads=h)
        if pair is None:
            r1 = qkv1.view(b, n, 3, h, ch // h)
            r2 = qkv2.view(b, m, 3, h, ch // h)
            pair = (ref.sdpa_bnhd(r1[:, :, 0], r2[:, :, 1], r2[:, :, 2],
                                  scale=scale_x).reshape(b, n, ch),
                    ref.sdpa_bnhd(r2[:, :, 0], r1[:, :, 1], r1[:, :, 2],
                                  scale=scale_c).reshape(b, m, ch))
        return self.proj_x(pair[0]), self.proj_c(pair[1])


class DualCrossAttentionV2(_Attention):
    """Cheaper DCA: q and v1 from x, k and v2 from c; q and k serve both
    directions (the general DCA with q1 = k1 = q and q2 = k2 = k)."""

    def __init__(self, dim: int, num_heads: int, attn_backend: str = "auto"):
        super().__init__(num_heads, attn_backend)
        self.qv1 = nn.Linear(dim, 2 * dim)
        self.kv2 = nn.Linear(dim, 2 * dim)
        self.proj_x = nn.Linear(dim, dim)
        self.proj_c = nn.Linear(dim, dim)

    def forward(self, x, c):
        b, n, ch = x.shape
        m = c.shape[1]
        h = self.num_heads
        scale_x, scale_c = ref.dca_scales(n, m, ch)
        q, v1 = self.qv1(x).split(ch, dim=-1)
        k, v2 = self.kv2(c).split(ch, dim=-1)
        pair = None
        if use_kernel(self.attn_backend, x) and shapes_ok(
                self.attn_backend, x, dca_mod.kernel_takes(ch, h, m, q.dtype)):
            pair = dca_mod.dca(q, q, v1, k, k, v2, scale_x=scale_x,
                               scale_c=scale_c, num_heads=h)
        if pair is None:
            def heads(t):
                return t.unflatten(-1, (h, ch // h))
            pair = (ref.sdpa_bnhd(heads(q), heads(k), heads(v2),
                                  scale=scale_x).reshape(b, n, ch),
                    ref.sdpa_bnhd(heads(k), heads(q), heads(v1),
                                  scale=scale_c).reshape(b, m, ch))
        return self.proj_x(pair[0]), self.proj_c(pair[1])
