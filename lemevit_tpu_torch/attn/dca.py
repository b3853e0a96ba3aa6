"""Dual cross-attention, attention only: counterpart of
lemevit_tpu/attn/pallas_dca.py.

  dca(q1, k1, v1, q2, k2, v2, *, scale_x, scale_c, num_heads)
      -> (x_out, c_out), or None where the JAX package declines

q1, k1, v1 are (B, N, C) image-token projections and q2, k2, v2 (B, M, C)
meta-token projections, C = num_heads * head_dim. Per head:
  x_out = softmax(q1 k2^T * scale_x) v2   each image token over the M meta keys
  c_out = softmax(q2 k1^T * scale_c) v1   each meta token over the N image keys
with the softmax in fp32, outputs in the input type. ``dca`` returns None
under the JAX package's conditions (M % 8, C % num_heads, no N tile from
``pick_tile``), so the same calls go to a kernel in both packages; the
attention modules then compose.

The inputs may be column views of one projection output (``lin.split(C,
-1)``: rows of a common stride, images N rows apart), as the D and D2
modules pass them; the kernel reads them in place. Inputs laid out
otherwise are copied first.

For CUDA tensors the forward launches the hand-written kernel
``csrc/dca_attn.cu`` (``dca_kernel``, entry ``lm_dca_attn``) or raises; for
CPU tensors it runs ``dca_plain``, through the same autograd Function. The
backward recomputes ``dca_plain`` under autograd and takes its vector-Jacobian
product, as the JAX package's ``_dca_bwd`` takes ``jax.vjp`` of its XLA
composition; a tensor passed twice (D2's ``dca(q, q, v1, k, k, v2)``) gets
the sum of its two gradients from autograd. The kernel takes head_dim 32,
as every released variant has: on CUDA tensors another head_dim raises,
it does not compose.

``LAUNCHES["dca_attn"]`` counts kernel launches (one per call on CUDA
tensors; the plain version does not count).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import sdpa_bnhd

LAUNCHES = {"dca_attn": 0}


def pick_tile(n: int) -> int:
    """The JAX package's N tile (lemevit_tpu/attn/pallas_dca.py:173-182),
    0 where none fits; the port's kernel needs no tile, but a call the JAX
    package declines is declined here too."""
    if n <= 512 and n % 16 == 0:
        return n
    for tile in (512, 448, 256, 224, 128, 112):
        if n % tile == 0:
            return tile
    return 0


def dca_plain(q1, k1, v1, q2, k2, v2, *, scale_x: float, scale_c: float,
              num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions composed in PyTorch (the JAX package's _xla_dca)."""
    b, n, c = q1.shape
    m = q2.shape[1]

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], num_heads, c // num_heads)
    xo = sdpa_bnhd(split(q1), split(k2), split(v2), scale=scale_x)
    co = sdpa_bnhd(split(q2), split(k1), split(v1), scale=scale_c)
    return xo.reshape(b, n, c), co.reshape(b, m, c)


def rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, ld): t (B, L, C) as the attention kernels read it, rows ld
    elements apart with unit column stride and images L rows apart. A
    column view of a projection output passes as it is; a tensor laid out
    otherwise is copied."""
    _, length, c = t.shape
    s0, s1, s2 = t.stride()
    if s2 == 1 and s1 >= c and (t.shape[0] == 1 or s0 == length * s1):
        return t, s1
    return t.contiguous(), c


def key_rows(k: torch.Tensor, v: torch.Tensor):
    """(k, v, ld): keys and values sharing one leading dimension."""
    (k, ldk), (v, ldv) = rows(k), rows(v)
    if ldk != ldv:
        k, v, ldk = k.contiguous(), v.contiguous(), k.shape[2]
    return k, v, ldk


def check_inputs(name: str, tensors, num_heads: int) -> None:
    """Raise on what the attention kernels do not take."""
    x = tensors[0]
    ch = x.shape[-1]
    if x.dtype not in fb._DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16 expected, got {x.dtype}")
    if ch != num_heads * fb.HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {fb.HEAD_DIM}; "
                         f"C={ch} with {num_heads} heads")
    for i, t in enumerate(tensors):
        if t.dim() != 3 or t.shape[0] != x.shape[0] or t.shape[2] != ch:
            raise ValueError(f"{name}: tensor {i} has shape "
                             f"{tuple(t.shape)}, expected (B, L, {ch})")
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: tensor {i} is on {t.device}, "
                             f"expected {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: tensor {i} is {t.dtype}, "
                            f"expected {x.dtype}")


def dca_kernel(q1, k1, v1, q2, k2, v2, *, scale_x: float, scale_c: float,
               num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions through csrc/dca_attn.cu on CUDA tensors."""
    check_inputs("dca_attn", (q1, k1, v1, q2, k2, v2), num_heads)
    b, n, c = q1.shape
    m = q2.shape[1]
    if k1.shape[1] != n or v1.shape[1] != n or k2.shape[1] != m \
            or v2.shape[1] != m:
        raise ValueError("dca_attn: q1 / k1 / v1 need N rows, q2 / k2 / v2 "
                         "M rows")
    q1, ld_q1 = rows(q1)
    q2, ld_q2 = rows(q2)
    k1, v1, ld_kv1 = key_rows(k1, v1)
    k2, v2, ld_kv2 = key_rows(k2, v2)
    xo = torch.empty(b, n, c, dtype=q1.dtype, device=q1.device)
    co = torch.empty(b, m, c, dtype=q1.dtype, device=q1.device)
    work = fb._partials(b, num_heads, m, n, q1.device)
    fb._launch("dca_attn", q1, [q1, k1, v1, q2, k2, v2, xo, co, *work],
               b, n, m, c, num_heads, ld_q1, ld_kv1, ld_q2, ld_kv2,
               fb.KEYS_PER_SPLIT, scale_x, scale_c, counts=LAUNCHES)
    return xo, co


class _Dca(torch.autograd.Function):
    """Kernel (or, on the CPU, plain) forward; backward through dca_plain."""

    @staticmethod
    def forward(ctx, q1, k1, v1, q2, k2, v2, scale_x, scale_c, num_heads):
        kw = dict(scale_x=scale_x, scale_c=scale_c, num_heads=num_heads)
        ctx.save_for_backward(q1, k1, v1, q2, k2, v2)
        ctx.kw = kw
        fn = dca_kernel if q1.is_cuda else dca_plain
        return fn(q1, k1, v1, q2, k2, v2, **kw)

    @staticmethod
    def backward(ctx, dxo, dco):
        return (*recompute_vjp(dca_plain, ctx, (dxo, dco)), None, None, None)


def recompute_vjp(plain, ctx, grads) -> list:
    """Gradients of ``ctx``'s saved inputs: ``plain`` recomputed on them
    under autograd, its vector-Jacobian product with ``grads``. Each saved
    tensor is a separate leaf, so one passed twice gets two gradients, and
    autograd sums them."""
    leaves = [t.detach().requires_grad_(need) for t, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*leaves, **ctx.kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wanted, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if t.requires_grad else None for t in leaves]


def dca(q1, k1, v1, q2, k2, v2, *, scale_x: float, scale_c: float,
        num_heads: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Both DCA directions; see the module docstring. None where the JAX
    package declines (lemevit_tpu/attn/pallas_dca.py:193)."""
    _, n, c = q1.shape
    m = q2.shape[1]
    if m % 8 != 0 or c % num_heads != 0 or pick_tile(n) == 0:
        return None
    return _Dca.apply(q1, k1, v1, q2, k2, v2, float(scale_x),
                      float(scale_c), num_heads)
