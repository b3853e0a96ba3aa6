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
otherwise, or not 16-byte aligned, are copied first.

For CUDA tensors the forward launches the hand-written kernel
``csrc/dca_attn.cu`` (``dca_kernel``, entry ``lm_dca_attn``) or raises; for
CPU tensors it runs ``dca_plain``, through the same autograd Function. The
kernel replaces pallas_dca.py's ``_dca_forward``; it is bound by bytes on
the H100 (16 operations per byte in bf16 at M = 16), so it reads every
image row once, in one launch: a CTA takes ``TILE[dtype]`` image rows of
one image (128 in bf16, 64 in fp32) through every head and both
directions, the meta tokens in tiles of 16, on mma.sync in bf16 and on FMA
products in fp32 (one design for both types), and writes the c
direction's partial softmax of its rows to fp32 workspace
(``workspace``); a second launch merges the partials in a fixed order, so
two runs give the same bits. ``dca_tiles_plain`` follows that order of
work in PyTorch, for the tests. The kernel takes head_dim 32, as every
released variant has, and up to ``MAX_META[dtype]`` meta tokens, whose
rows of one head sit in shared memory beside the image rows (every
released variant has 16, LeMeViT's constructor defaults to 128), in fp32
or bf16 (``kernel_takes``): the attention modules ask ``kernel_takes``
first under ``attn_backend="auto"`` and compose where it says no; a
direct call (or ``"cuda"``) with other shapes raises.

The backward recomputes ``dca_plain`` under autograd and takes its
vector-Jacobian product, as the JAX package's ``_dca_bwd`` takes ``jax.vjp``
of its XLA composition; a tensor passed twice (D2's ``dca(q, q, v1, k, k,
v2)``) gets the sum of its two gradients from autograd.

``LAUNCHES["dca_attn"]`` counts calls of ``lm_dca_attn``, one per call on
CUDA tensors; the merge is that call's second launch and is not counted
apart (the plain version does not count).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import sdpa_bnhd

LAUNCHES = {"dca_attn": 0}
# image rows per CTA of csrc/dca_attn.cu, by input type (attn_tc.cuh,
# DcaTile)
TILE = {torch.bfloat16: 128, torch.float32: 64}
WARP_KEYS = 16   # image keys of one warp's c-direction partial
META_TILE = 16   # meta tokens of one m tile (c direction) / key tile (x)
# the most meta tokens whose rows fit in the kernel's shared memory (227 KB
# beside the tile's image rows, attn_tc.cuh::dca_smem_bytes)
MAX_META = {torch.bfloat16: 304, torch.float32: 192}
MERGE_WARPS = 8  # warps of the merge launch, each folding every 8th tile
LOG2E = 1.4426950408889634


def kernel_takes(c: int, num_heads: int, m: int, dtype) -> bool:
    """Whether the kernel takes C = ``c`` with ``num_heads`` heads and
    ``m`` meta tokens in ``dtype``: head_dim 32, fp32 or bf16, m <=
    MAX_META[dtype] (``check_inputs``' and ``dca_kernel``'s limits),
    decided from shapes alone, without CUDA."""
    return (dtype in fb._DTYPES and c == num_heads * fb.HEAD_DIM
            and m <= MAX_META[dtype])


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


def n_tiles(n: int, tile: int) -> int:
    """CTAs of the kernel per image: ceil(n / tile)."""
    return -(-n // tile)


def workspace_rows(b: int, h: int, m: int, n: int, tile: int) -> int:
    """Rows of the kernel's fp32 workspace: one per (image, head, tile,
    meta query), holding the c direction's partial softmax over the tile's
    image keys (max, sum, 32-channel sums)."""
    return b * h * n_tiles(n, tile) * m


def workspace(b: int, h: int, m: int, n: int, tile: int, device):
    """The workspace as one fp32 tensor: every row's max, then every row's
    sum, then every row's 32 sums."""
    return torch.empty(workspace_rows(b, h, m, n, tile) * (2 + fb.HEAD_DIM),
                       dtype=torch.float32, device=device)


def _heads(t, num_heads):
    """(B, L, C) -> (B, H, L, C / H) in fp32."""
    return t.reshape(t.shape[0], t.shape[1], num_heads, -1).transpose(
        1, 2).float()


def _x_tiles(q1, k2, v2, scale_x, num_heads):
    """The x direction in k_dca_tc's order of work: (x_out, lse_x)."""
    b, n, c = q1.shape
    m = k2.shape[1]
    s = _heads(q1, num_heads) @ _heads(k2, num_heads).transpose(-1, -2)
    sl2 = scale_x * LOG2E
    top = s.new_full(s.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(top)
    for k0 in range(0, m, META_TILE):
        part = s[..., k0:k0 + META_TILE]
        new = torch.maximum(top, part.amax(-1, keepdim=True))
        l = l * torch.exp2((top - new) * sl2) + torch.exp2(
            part * sl2 - new * sl2).sum(-1, keepdim=True)
        top = new
    p = (torch.exp2(s * sl2 - top * sl2) / l).to(v2.dtype).float()
    xo = (p @ _heads(v2, num_heads)).transpose(1, 2).reshape(b, n, c)
    lse = (top * scale_x + torch.log(l)).squeeze(-1)
    return xo.to(v2.dtype), lse


def dca_c_tiles_plain(q2, k1, v1, *, scale_c: float, num_heads: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The c direction alone in k_dca_tc's order of work, in PyTorch (used
    by the tests only; the C block's attention): the partial softmax per
    warp of WARP_KEYS image keys (P rounded before P v1), merged in warp
    order into each tile of TILE[dtype] rows, then the tiles merged as the
    merge launch does: its warp w folds tiles w, w + MERGE_WARPS, ... in
    order, then the warps fold in order. Returns (c_out, lse_c): the
    output in the input type and each meta query's log-sum-exp (B, H, M)
    in fp32, natural log (m scale + ln l, from the merged maximum and
    sum)."""
    dt = v1.dtype
    tile = TILE[dt]
    b, n, c = k1.shape
    m, d = q2.shape[1], c // num_heads
    sl2 = scale_c * LOG2E
    tiles, w = n_tiles(n, tile), tile // WARP_KEYS
    pad = tiles * tile - n
    s = F.pad(_heads(q2, num_heads) @ _heads(k1, num_heads).transpose(-1, -2),
              (0, pad), value=-float("inf"))
    s = s.reshape(b, num_heads, m, tiles, w, WARP_KEYS)
    v = F.pad(_heads(v1, num_heads), (0, 0, 0, pad)).reshape(
        b, num_heads, tiles, w, WARP_KEYS, d)
    mw = s.amax(-1)                              # (B, H, M, tiles, w)
    ref = torch.where(torch.isinf(mw), torch.zeros_like(mw), mw)
    p = torch.exp2(s * sl2 - ref[..., None] * sl2)
    lw = p.sum(-1)
    aw = torch.einsum("bhmtwk,bhtwkd->bhmtwd", p.to(dt).float(), v)

    def merge(mx, l, acc, groups=1):
        """Fold partials along the last axis of (max, sum), the one before
        last of the sums: group g folds g, g + groups, ... in order, then
        the groups fold in order."""
        top = mx.amax(-1)
        big_l = torch.zeros_like(top)
        big_a = torch.zeros_like(acc[..., 0, :])
        for grp in range(groups):
            part_l, part_a = torch.zeros_like(big_l), torch.zeros_like(big_a)
            for i in range(grp, mx.shape[-1], groups):
                wt = torch.exp2((mx[..., i] - top) * sl2)
                part_l = part_l + wt * l[..., i]
                part_a = part_a + wt[..., None] * acc[..., i, :]
            big_l, big_a = big_l + part_l, big_a + part_a
        return top, big_l, big_a

    mt, lt, at = merge(mw, lw, aw)               # each tile, warps in order
    top, big_l, big_a = merge(mt, lt, at, MERGE_WARPS)  # the tiles
    co = (big_a / big_l[..., None]).transpose(1, 2).reshape(b, m, c)
    return co.to(dt), top * scale_c + torch.log(big_l)


def dca_tiles_plain(q1, k1, v1, q2, k2, v2, *, scale_x: float,
                    scale_c: float, num_heads: int, lse: bool = False):
    """Both directions in csrc/dca_attn.cu's order of work, in PyTorch
    (used by the tests only): the x direction's softmax over the meta keys
    in exp2 with the scale folded in, each row's maximum and sum taken
    over key tiles of META_TILE in order (online), then P normalised and
    rounded to the input type before P v2; the c direction as
    ``dca_c_tiles_plain``. Returns (x_out, c_out), with ``lse`` also each
    row's log-sum-exp in fp32, natural log, (B, H, N) and (B, H, M), as
    the D training forward's instance writes them (m scale + ln l from
    the x direction's first pass and the c direction's merge)."""
    xo, lx = _x_tiles(q1, k2, v2, scale_x, num_heads)
    co, lc = dca_c_tiles_plain(q2, k1, v1, scale_c=scale_c,
                               num_heads=num_heads)
    return (xo, co, lx, lc) if lse else (xo, co)


def rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, ld): t (B, L, C) as the attention kernels read it, rows ld
    elements apart with unit column stride and images L rows apart, every
    row 16-byte aligned (the kernels copy rows 16 bytes at a time). A
    column view of a projection output passes as it is; a tensor laid out
    otherwise is copied."""
    _, length, c = t.shape
    s0, s1, s2 = t.stride()
    per16 = 16 // t.element_size()  # elements per 16-byte copy
    if s2 == 1 and s1 >= c and (t.shape[0] == 1 or s0 == length * s1) \
            and s1 % per16 == 0 and t.data_ptr() % 16 == 0:
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
    if m > MAX_META[q1.dtype]:
        raise ValueError(f"dca_attn: the kernel takes at most "
                         f"{MAX_META[q1.dtype]} meta tokens in "
                         f"{q1.dtype}, got {m}")
    q1, ld_q1 = rows(q1)
    q2, ld_q2 = rows(q2)
    k1, v1, ld_kv1 = key_rows(k1, v1)
    k2, v2, ld_kv2 = key_rows(k2, v2)
    xo = torch.empty(b, n, c, dtype=q1.dtype, device=q1.device)
    co = torch.empty(b, m, c, dtype=q1.dtype, device=q1.device)
    tile = TILE[q1.dtype]
    work = workspace(b, num_heads, m, n, tile, q1.device)
    rows_ = workspace_rows(b, num_heads, m, n, tile)
    fb._launch("dca_attn", q1, [q1, k1, v1, q2, k2, v2, xo, co,
                                work[:rows_], work[rows_:2 * rows_],
                                work[2 * rows_:]],
               b, n, m, c, num_heads, ld_q1, ld_kv1, ld_q2, ld_kv2,
               scale_x, scale_c, counts=LAUNCHES)
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
