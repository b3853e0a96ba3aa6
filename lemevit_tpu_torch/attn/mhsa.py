"""Multi-head self-attention, attention only: counterpart of
lemevit_tpu/attn/pallas_mhsa.py.

  mhsa(q, k, v, *, scale=None, num_heads)  (B, N, C) -> (B, N, C), or None
  sdpa(q, k, v, *, scale=None)             (B, N, H, d) adapter, or None

softmax(q k^T * scale) v per head (scale head_dim^-1/2 by default), the
softmax in fp32, the output in the input type. Both return None under the
JAX package's conditions, so the same calls go to a kernel in both
packages and the attention modules compose the rest: N above ``MAX_N``,
C not a multiple of num_heads, a working set above ``MAX_BYTES``, and for
``sdpa`` keys of another length than the queries (cross-attention).

q, k and v may be column views of the qkv projection (``qkv.split(C,
-1)``), read in place. For CUDA tensors the forward launches the
hand-written kernel ``csrc/mhsa.cu`` (``mhsa_kernel``, entry ``lm_mhsa``)
or raises; for CPU tensors it runs ``mhsa_plain``, through the same
autograd Function, whose backward recomputes ``mhsa_plain`` under autograd
(the JAX package's ``_mhsa_bwd``).

The kernel replaces pallas_mhsa.py's ``_mhsa_op``. On the H100 it is bound
by operations from N ~ 600 on (and, at head_dim 32, by the exponentials
nearly as much), by bytes below. Its design is FlashAttention-2's: 128
queries of one (image, head) per CTA in bf16 (64 in fp32), 64-key tiles in
flight by cp.async, the products on mma.sync, the online softmax in
registers in steps of 32 keys with P rounded to the input type before
P v (``mhsa_tiles_plain`` follows that order of work in PyTorch, for the
tests); at N <= 16 each warp takes a whole (image, head). Both types take
that kernel: bf16 on the tensor cores, fp32 on FMA products of the same
tiles. It takes head_dim 32, as every released variant has: on CUDA
tensors another head_dim raises, it does not compose.

``LAUNCHES["mhsa"]`` counts kernel launches (one per call on CUDA tensors;
the plain version does not count).
"""
from __future__ import annotations

from typing import Optional

import torch

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.dca import (LOG2E, check_inputs, key_rows,
                                        recompute_vjp, rows)
from lemevit_tpu_torch.attn.reference import sdpa_bnhd

# The JAX package's limits: the longest sequence its kernel takes
# (lemevit_tpu/attn/pallas_mhsa.py:34, _MAX_N) and its working-set budget,
# 4 N C bytes of q, k, v and out plus 8 N^2 of fp32 scores (:35,
# _MAX_VMEM_BYTES, applied at :107-110).
MAX_N = 1024
MAX_BYTES = 12 * 1024 * 1024

LAUNCHES = {"mhsa": 0}
KEY_STEP = 32  # keys per online-softmax step of csrc/mhsa.cu


def takes(n: int, c: int, num_heads: int, itemsize: int) -> bool:
    """Whether the JAX package runs its kernel on (B, n, c) inputs of
    ``itemsize`` bytes (lemevit_tpu/attn/pallas_mhsa.py:105-110)."""
    return (n <= MAX_N and c % num_heads == 0
            and 4 * n * c * itemsize + 8 * n * n <= MAX_BYTES)


def kernel_takes(c: int, num_heads: int, dtype) -> bool:
    """Whether the kernel takes (B, n, c) inputs of ``dtype`` with
    ``num_heads`` heads: head_dim 32, fp32 or bf16 (``check_inputs``'
    limits), decided from shapes alone, without CUDA."""
    return dtype in fb._DTYPES and c == num_heads * fb.HEAD_DIM


def mhsa_plain(q, k, v, *, scale: float, num_heads: int) -> torch.Tensor:
    """Self-attention composed in PyTorch (the JAX package's _xla_mhsa)."""
    b, n, c = q.shape

    def split(t):
        return t.reshape(b, n, num_heads, c // num_heads)
    return sdpa_bnhd(split(q), split(k), split(v), scale=scale).reshape(
        b, n, c)


def mhsa_tiles_plain(q, k, v, *, scale: float, num_heads: int
                     ) -> torch.Tensor:
    """Self-attention in csrc/mhsa.cu's order of work, in PyTorch (used by
    the tests only): keys in steps of KEY_STEP, an online softmax in exp2
    with the scale folded in, P rounded to the input type before P v, one
    division at the end."""
    b, n, c = q.shape
    d = c // num_heads

    def heads(t):  # (B, H, N, d) in fp32
        return t.reshape(b, n, num_heads, d).transpose(1, 2).float()
    qh, kh, vh = heads(q), heads(k), heads(v)
    sl2 = scale * LOG2E
    mx = qh.new_full((b, num_heads, n, 1), -float("inf"))
    l = qh.new_zeros(b, num_heads, n, 1)
    o = qh.new_zeros(b, num_heads, n, d)
    for k0 in range(0, n, KEY_STEP):
        s = qh @ kh[:, :, k0:k0 + KEY_STEP].transpose(-1, -2)
        m_new = torch.maximum(mx, s.amax(-1, keepdim=True))
        alpha = torch.exp2((mx - m_new) * sl2)
        p = torch.exp2(s * sl2 - m_new * sl2)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(v.dtype).float() @ vh[:, :, k0:k0 + KEY_STEP]
        mx = m_new
    return (o / l).transpose(1, 2).reshape(b, n, c).to(q.dtype)


def mhsa_kernel(q, k, v, *, scale: float, num_heads: int) -> torch.Tensor:
    """Self-attention through csrc/mhsa.cu on CUDA tensors."""
    check_inputs("mhsa", (q, k, v), num_heads)
    b, n, c = q.shape
    if k.shape[1] != n or v.shape[1] != n:
        raise ValueError("mhsa: q, k and v need the same length")
    q, ldq = rows(q)
    k, v, ldkv = key_rows(k, v)
    out = torch.empty(b, n, c, dtype=q.dtype, device=q.device)
    fb._launch("mhsa", q, [q, k, v, out], b, n, c, num_heads, ldq, ldkv,
               scale, counts=LAUNCHES)
    return out


class _Mhsa(torch.autograd.Function):
    """Kernel (or, on the CPU, plain) forward; backward through
    mhsa_plain."""

    @staticmethod
    def forward(ctx, q, k, v, scale, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(scale=scale, num_heads=num_heads)
        fn = mhsa_kernel if q.is_cuda else mhsa_plain
        return fn(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, dout):
        return (*recompute_vjp(mhsa_plain, ctx, (dout,)), None, None)


def mhsa(q, k, v, *, scale: Optional[float] = None, num_heads: int
         ) -> Optional[torch.Tensor]:
    """Self-attention over (B, N, C); see the module docstring."""
    _, n, c = q.shape
    if not takes(n, c, num_heads, q.element_size()):
        return None
    if scale is None:
        scale = (c // num_heads) ** -0.5
    return _Mhsa.apply(q, k, v, float(scale), num_heads)


def sdpa(q, k, v, *, scale: Optional[float] = None
         ) -> Optional[torch.Tensor]:
    """(B, N, H, d) adapter of mhsa for the modules' generic attention:
    self-attention shapes only, None for cross shapes
    (lemevit_tpu/attn/pallas_mhsa.py:114-126)."""
    b, n, h, d = q.shape
    if k.shape[1] != n:
        return None
    out = mhsa(q.reshape(b, n, h * d), k.reshape(b, n, h * d),
               v.reshape(b, n, h * d), scale=scale, num_heads=h)
    return None if out is None else out.reshape(b, n, h, d)
