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
(the JAX package's ``_mhsa_bwd``). The kernel takes head_dim 32, as every
released variant has: on CUDA tensors another head_dim raises, it does not
compose.

``LAUNCHES["mhsa"]`` counts kernel launches (one per call on CUDA tensors;
the plain version does not count).
"""
from __future__ import annotations

from typing import Optional

import torch

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.dca import (check_inputs, key_rows,
                                        recompute_vjp, rows)
from lemevit_tpu_torch.attn.reference import sdpa_bnhd

# The JAX package's limits: the longest sequence its kernel takes
# (lemevit_tpu/attn/pallas_mhsa.py:34, _MAX_N) and its working-set budget,
# 4 N C bytes of q, k, v and out plus 8 N^2 of fp32 scores (:35,
# _MAX_VMEM_BYTES, applied at :107-110).
MAX_N = 1024
MAX_BYTES = 12 * 1024 * 1024

LAUNCHES = {"mhsa": 0}


def takes(n: int, c: int, num_heads: int, itemsize: int) -> bool:
    """Whether the JAX package runs its kernel on (B, n, c) inputs of
    ``itemsize`` bytes (lemevit_tpu/attn/pallas_mhsa.py:105-110)."""
    return (n <= MAX_N and c % num_heads == 0
            and 4 * n * c * itemsize + 8 * n * n <= MAX_BYTES)


def mhsa_plain(q, k, v, *, scale: float, num_heads: int) -> torch.Tensor:
    """Self-attention composed in PyTorch (the JAX package's _xla_mhsa)."""
    b, n, c = q.shape

    def split(t):
        return t.reshape(b, n, num_heads, c // num_heads)
    return sdpa_bnhd(split(q), split(k), split(v), scale=scale).reshape(
        b, n, c)


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
