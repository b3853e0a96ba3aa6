"""Whole-block LeMeBlock kernels for inference: C, D (and D2) and S blocks,
and a whole stage of S blocks.

Each public function takes the block's input tokens and a parameter tuple in
the order of ``lemevit_tpu.attn.pallas_block`` (norm1, attention
projections, norm2, MLP), with every matrix in torch ``nn.Linear`` layout
(out_features, in_features), and returns the block's output tokens:

  c_block(x, c, params, num_heads, cpe, img_w)                      -> c
  dca_block(x, c, params, num_heads, scale_x, scale_c, cpe, img_w)  -> (x, c)
  s_block(x, c, params, num_heads, cpe, img_w)                      -> (x, c)
  s_stage(x, c, params_list, num_heads, cpes, img_w)                -> (x, c)

x is (B, N, C) image tokens, N = H * img_w; c is (B, M, C) meta tokens.
Without ``cpe`` x is after the conditional position embedding (the 3x3
depthwise CPE ran outside, as a ``F.conv2d``). With ``cpe`` = (taps (9, C)
in (ky, kx) order, bias (C,)) x is *before* it and the kernel applies it
(``cpe_plain`` is the same function in PyTorch); the C block returns only c,
the D and S blocks return the CPE'd stream's update. ``s_stage`` runs one
``s_block`` per parameter tuple in one launch, each with its own pair of
``cpes`` (or none). Pre-norm, no layer-scale, no DropPath: the inference
form of every released LeMeViT variant.

For a CUDA tensor a function launches its hand-written kernel
(``csrc/{c,dca,s}_block.cu``, ``csrc/s_stage.cu``, built by ``_build``) or
raises; for a CPU tensor it runs its ``*_plain`` version, the PyTorch
composition the kernels are tested against. The TPU kernels applied the
LayerNorm affine by folding it into the next matmul's weights; here the
kernels apply LayerNorm (statistics and affine) in the prologue of the
product it feeds, so nothing is folded and the weights are used as given.

The C, D and S kernels run on the tensor cores (``csrc/block_tc.cuh`` for
the qkv product and the tail, ``csrc/attn_tc.cuh`` for the attention);
``c_block_tiles_plain``, ``s_block_tiles_plain``,
``dca_block_tiles_plain`` and ``s_stage_tiles_plain`` follow their order of
work in PyTorch, rounding where they round, for the tests. ``s_stage``'s
kernel runs the S block's tiles as work items of one persistent launch, in
the order and with the dependencies of ``stage_schedule``, a table built
here from the shapes alone (cached per shape) and copied to the device. The D kernel
takes at most ``attn/dca.py``'s ``MAX_META`` meta tokens (a head's meta
rows sit in shared memory); on CUDA tensors more raise.

``LAUNCHES[name]`` counts kernel launches of each block (one per call on
CUDA tensors; the plain versions do not count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lemevit_tpu_torch.attn.reference import sdpa_bnhd

LN_EPS = 1e-6          # the blocks' norm1 / norm2
HEAD_DIM = 32          # the kernels assign one lane per head channel
MAX_DIM = 640          # the tails keep their rows of t1 and LN2(t1) on
                       # chip: 64 (block_tc.cuh, C <= 512) or 32
                       # (block_common.cuh) rows at a time
HIDDEN_CHUNK = 128     # hidden columns of one MLP chunk (both headers'
                       # tails)
MAX_N_STAGE = 1024     # lemevit_tpu/attn/pallas_block.py:38 _MAX_N_SBLOCK

# s_stage's work items (csrc/s_stage.cu, on block_tc.cuh's and attn_tc.cuh's
# tiles): rows of a qkv item and of a tail item (QkvWg / TailWg kRows; past
# C = 512 block_common.cuh's kTailBM), output columns of a qkv tile (QkvWg
# kBN), the token count at or below which a warp takes an (image, head)
# whole (kTcSmall), queries of a warpgroup's attention unit (MhsaTile kQ),
# attention units per item (two warpgroups, or eight warps), the card's
# SMs (the qkv columns are split over groups where the row blocks are
# fewer), and the bytes of one block's weight table (s_stage.cu StageBlock).
STAGE_ROWS, STAGE_TAIL_ROWS_WIDE = 64, 32
QKV_TILE = 128
SMALL_N = 16
ATTN_QUERIES = {torch.bfloat16: 128, torch.float32: 64}
UNITS_ROWS, UNITS_SMALL = 2, 8
CARD_SMS = 132
STAGE_BLOCK_BYTES = 896
# the phases of a stage's blocks, the phase each waits for, and the fields
# of a schedule row (s_stage.cu's enum)
QKV, ATTN, TAIL = 0, 1, 2
WAITS_ON = {QKV: TAIL, ATTN: QKV, TAIL: ATTN}
STAGE_FIELDS = ("kind", "block", "stream", "index", "group", "first",
                "last", "wait_phase", "wait_mult")

LAUNCHES = {"c_block": 0, "dca_block": 0, "s_block": 0, "s_stage": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------- plain


def _ln(t, w, b):
    return F.layer_norm(t, (t.shape[-1],), w, b, LN_EPS)


def _mlp_residual(t, ln_w, ln_b, w1, b1, w2, b2):
    return t + F.linear(F.gelu(F.linear(_ln(t, ln_w, ln_b), w1, b1)), w2, b2)


def cpe_plain(x, taps, bias, img_w: int) -> torch.Tensor:
    """The conditional position embedding x + dwconv3x3(x) + bias of (B, N,
    C) tokens from images img_w wide, zero-padded at each image's edges: a
    depthwise ``F.conv2d`` on the NHWC view, as ``core/layers.py::DWConv``
    computes it. taps (9, C) in (ky, kx) order, bias (C,)."""
    b, n, ch = x.shape
    img = x.reshape(b, n // img_w, img_w, ch).permute(0, 3, 1, 2)
    y = F.conv2d(img, taps.t().reshape(ch, 1, 3, 3), bias, padding=1,
                 groups=ch)
    return x + y.permute(0, 2, 3, 1).reshape(b, n, ch)


def _with_cpe(x, cpe, img_w):
    return x if cpe is None else cpe_plain(x, *cpe, img_w)


def c_block_plain(x, c, params, *, num_heads: int, cpe=None,
                  img_w: int = 0) -> torch.Tensor:
    """Pre-norm C block: c attends to LN1(x) (keys/values), proj, residual,
    norm2 + MLP. Returns the new c. With ``cpe`` the keys and values come
    from the CPE of x."""
    x = _with_cpe(x, cpe, img_w)
    (ln1w, ln1b, wq, bq, wkv, bkv, wp, bp, ln2w, ln2b, w1, b1, w2, b2) = params
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    q = F.linear(_ln(c, ln1w, ln1b), wq, bq).view(b, m, h, ch // h)
    kv = F.linear(_ln(x, ln1w, ln1b), wkv, bkv).view(b, n, 2, h, ch // h)
    o = sdpa_bnhd(q, kv[:, :, 0], kv[:, :, 1]).reshape(b, m, ch)
    c1 = c + F.linear(o, wp, bp)
    return _mlp_residual(c1, ln2w, ln2b, w1, b1, w2, b2)


def dca_block_plain(x, c, params, *, num_heads: int, scale_x: float,
                    scale_c: float, cpe=None, img_w: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm D block: x attends to the meta tokens, c to the image
    tokens (both from the block's input), proj_x / proj_c, residuals and
    the shared norm2 + MLP on both streams. With ``cpe`` x first goes
    through its CPE."""
    x = _with_cpe(x, cpe, img_w)
    (ln1w, ln1b, wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc,
     ln2w, ln2b, w1, b1, w2, b2) = params
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    qkv1 = F.linear(_ln(x, ln1w, ln1b), wqkv1, bqkv1).view(b, n, 3, h, ch // h)
    qkv2 = F.linear(_ln(c, ln1w, ln1b), wqkv2, bqkv2).view(b, m, 3, h, ch // h)
    ax = sdpa_bnhd(qkv1[:, :, 0], qkv2[:, :, 1], qkv2[:, :, 2],
                   scale=scale_x).reshape(b, n, ch)
    ac = sdpa_bnhd(qkv2[:, :, 0], qkv1[:, :, 1], qkv1[:, :, 2],
                   scale=scale_c).reshape(b, m, ch)
    x1 = x + F.linear(ax, wpx, bpx)
    c1 = c + F.linear(ac, wpc, bpc)
    return (_mlp_residual(x1, ln2w, ln2b, w1, b1, w2, b2),
            _mlp_residual(c1, ln2w, ln2b, w1, b1, w2, b2))


def s_block_plain(x, c, params, *, num_heads: int, cpe=None,
                  img_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm S block applied to x (after its CPE, with ``cpe``) and, with
    the same weights, to c."""
    x = _with_cpe(x, cpe, img_w)
    (ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1, w2, b2) = params

    def branch(t):
        b, n, ch = t.shape
        h = num_heads
        qkv = F.linear(_ln(t, ln1w, ln1b), wqkv, bqkv).view(b, n, 3, h,
                                                            ch // h)
        o = sdpa_bnhd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        t1 = t + F.linear(o.reshape(b, n, ch), wp, bp)
        return _mlp_residual(t1, ln2w, ln2b, w1, b1, w2, b2)

    return branch(x), branch(c)


def _ln_rounded(t, w, b, dt):
    """LayerNorm in fp32 of t (affine w, b; none where they are None, as
    the training kernels take folded weights), rounded to dt (the A operand
    of the next product), as fp32."""
    f = lambda a: None if a is None else a.float()
    return _ln(t.float(), f(w), f(b)).to(dt).float()


def _qkv_tiles(t, ln_w, ln_b, w, b, dt):
    """block_tc.cuh's k_qkv_wg: LN1(t) rounded to dt, its product in fp32
    plus the bias, rounded to dt."""
    return (_ln_rounded(t, ln_w, ln_b, dt) @ w.float().t()
            + b.float()).to(dt)


def _tail_tiles(t, o, wp, bp, ln_w, ln_b, w1, b1, w2, b2, dt, s1=None,
                s2=None):
    """block_tc.cuh's k_tail_wg (and block_common.cuh's k_block_tail past
    C = 512, which rounds in the same places): t1 = t + s1 (o Wp^T + bp) in
    fp32, LN2(t1) rounded to dt, then per HIDDEN_CHUNK hidden columns s2
    GELU(fc1) in fp32 rounded to dt and its fc2 added to t1 + s2 b2 in
    fp32; the sum rounded to dt. s1 / s2 are the training instance's
    per-image DropPath scales (B,), 1 where None (the inference instances).
    Returns (out, t1), both in dt (t1 as the training instance writes
    it)."""
    col = lambda s: 1.0 if s is None else s.view(-1, 1, 1)
    t1 = t.float() + col(s1) * (o.float() @ wp.float().t() + bp.float())
    a = _ln_rounded(t1, ln_w, ln_b, dt)
    acc = t1 + col(s2) * b2.float()
    for j0 in range(0, w1.shape[0], HIDDEN_CHUNK):
        j1 = j0 + HIDDEN_CHUNK
        h = col(s2) * F.gelu(a @ w1[j0:j1].float().t() + b1[j0:j1].float())
        acc = acc + h.to(dt).float() @ w2[:, j0:j1].float().t()
    return acc.to(dt), t1.to(dt)


def _cpe_rounded(x, cpe, img_w):
    """x's CPE in fp32 rounded to x's type, as the kernels stage it."""
    if cpe is None:
        return x
    return cpe_plain(x.float(), *[t.float() for t in cpe], img_w).to(x.dtype)


def s_block_tiles_plain(x, c, params, *, num_heads: int, cpe=None,
                        img_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The S kernel's order of work in PyTorch (used by the tests only):
    LN1 rounded to the input type before the qkv product, qkv rounded,
    attention as ``attn/mhsa.py::mhsa_tiles_plain`` (32-key online-softmax
    steps, P rounded before P v), then the tail as k_tail_wg (LN2 rounded,
    each hidden chunk rounded after its GELU, fp32 sums, one rounding of
    the output). In fp32 nothing rounds."""
    from lemevit_tpu_torch.attn.mhsa import mhsa_tiles_plain
    dt = x.dtype
    x = _cpe_rounded(x, cpe, img_w)
    (ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1, w2, b2) = params
    ch = x.shape[-1]

    def branch(t):
        q, k, v = _qkv_tiles(t, ln1w, ln1b, wqkv, bqkv, dt).split(ch, -1)
        o = mhsa_tiles_plain(q, k, v, scale=HEAD_DIM ** -0.5,
                             num_heads=num_heads)
        return _tail_tiles(t, o, wp, bp, ln2w, ln2b, w1, b1, w2, b2, dt)[0]

    return branch(x), branch(c)


def dca_block_tiles_plain(x, c, params, *, num_heads: int, scale_x: float,
                          scale_c: float, cpe=None, img_w: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The D kernel's order of work in PyTorch (used by the tests only):
    the qkv products and the tails as ``s_block_tiles_plain``'s, both
    attention directions as ``attn/dca.py::dca_tiles_plain`` (the c
    direction's partials per tile of image rows merged in the merge
    launch's fixed order)."""
    from lemevit_tpu_torch.attn.dca import dca_tiles_plain
    dt = x.dtype
    x = _cpe_rounded(x, cpe, img_w)
    (ln1w, ln1b, wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc,
     ln2w, ln2b, w1, b1, w2, b2) = params
    ch = x.shape[-1]
    q1, k1, v1 = _qkv_tiles(x, ln1w, ln1b, wqkv1, bqkv1, dt).split(ch, -1)
    q2, k2, v2 = _qkv_tiles(c, ln1w, ln1b, wqkv2, bqkv2, dt).split(ch, -1)
    ax, ac = dca_tiles_plain(q1, k1, v1, q2, k2, v2, scale_x=scale_x,
                             scale_c=scale_c, num_heads=num_heads)
    return (_tail_tiles(x, ax, wpx, bpx, ln2w, ln2b, w1, b1, w2, b2, dt)[0],
            _tail_tiles(c, ac, wpc, bpc, ln2w, ln2b, w1, b1, w2, b2, dt)[0])


def c_block_tiles_plain(x, c, params, *, num_heads: int, cpe=None,
                        img_w: int = 0) -> torch.Tensor:
    """The C kernel's order of work in PyTorch (used by the tests only):
    with ``cpe`` the CPE'd x rounded once (k_qkv_wg's cpe mode); kv =
    LN1(x) Wkv^T + bkv and q = LN1(c) Wq^T + bq as k_qkv_wg computes them
    (LN1 and the product rounded); the meta queries over the image keys as
    ``attn/dca.py::dca_c_tiles_plain`` (per-warp partials merged per tile,
    the tiles merged in the merge launch's fixed order); the tail on the
    meta rows as s_block_tiles_plain's. In fp32 nothing rounds."""
    from lemevit_tpu_torch.attn.dca import dca_c_tiles_plain
    dt = x.dtype
    x = _cpe_rounded(x, cpe, img_w)
    (ln1w, ln1b, wq, bq, wkv, bkv, wp, bp, ln2w, ln2b, w1, b1, w2, b2) = params
    ch = x.shape[-1]
    k, v = _qkv_tiles(x, ln1w, ln1b, wkv, bkv, dt).split(ch, -1)
    q = _qkv_tiles(c, ln1w, ln1b, wq, bq, dt)
    o, _ = dca_c_tiles_plain(q, k, v, scale_c=HEAD_DIM ** -0.5,
                             num_heads=num_heads)
    return _tail_tiles(c, o, wp, bp, ln2w, ln2b, w1, b1, w2, b2, dt)[0]


def s_stage_plain(x, c, params_list, *, num_heads: int, cpes=None,
                  img_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stage of S blocks: ``s_block_plain`` with each block's parameters
    and CPE (``cpes[j]``, or none) in turn."""
    for j, params in enumerate(params_list):
        x, c = s_block_plain(x, c, params, num_heads=num_heads,
                             cpe=None if cpes is None else cpes[j],
                             img_w=img_w)
    return x, c


def s_stage_tiles_plain(x, c, params_list, *, num_heads: int, cpes=None,
                        img_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage kernel's order of work in PyTorch (used by the tests only):
    ``s_block_tiles_plain`` with each block's parameters and CPE in turn,
    x and c rounded to the input type between blocks, as the chain of
    ``s_block`` kernels rounds them (the stage runs the same tiles)."""
    for j, params in enumerate(params_list):
        x, c = s_block_tiles_plain(x, c, params, num_heads=num_heads,
                                   cpe=None if cpes is None else cpes[j],
                                   img_w=img_w)
    return x, c


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def stage_schedule(nb: int, b: int, n: int, m: int, ch: int,
                   num_heads: int, dtype) -> Tuple[np.ndarray, np.ndarray,
                                                   int]:
    """The ordered work items of ``s_stage``'s kernel for nb blocks at
    batch b, n image and m meta tokens, width ch: (items (K, 9) int32 with
    the STAGE_FIELDS of each row, counts (3, b) int32, qkv_tiles). A pure
    function of the shapes, run without CUDA; the kernel executes it row by
    row, each CTA claiming the next row.

    For each block j: the QKV items (each a STAGE_ROWS-row block of one
    stream, flat over the batch, x a group of qkv_tiles 128-column tiles),
    the ATTN items (UNITS_ROWS units of (image, head, ATTN_QUERIES queries),
    one a warpgroup, or at n <= SMALL_N UNITS_SMALL (image, head) pairs, one
    a warp), the TAIL items (row blocks, STAGE_TAIL_ROWS_WIDE rows past
    C = 512); each phase sorted by the last image it touches, both streams
    merged. An item waits for phase WAITS_ON[kind] of each image it touches
    (first .. last) to be done wait_mult blocks over: counts[phase][image]
    items of a phase touch an image in every block, so its counter reaching
    wait_mult * counts means blocks < wait_mult are done (an item of block
    j + 1 depends, through the chain, on every item of block j of its
    images). QKV(j) waits for TAIL(j - 1), ATTN(j) for QKV(j), TAIL(j) for
    ATTN(j): what each reads, the CPE's neighbour rows included (they stay
    within an image, so the table does not depend on the CPE or the image
    width), and what each overwrites. Every wait lies earlier in the list,
    so tickets taken in order cannot deadlock."""
    rows = (b * n, b * m)
    seq = (n, m)
    tail_rows = STAGE_ROWS if ch <= 512 else STAGE_TAIL_ROWS_WIDE
    tiles = _cdiv(3 * ch, QKV_TILE)
    row_blocks = sum(_cdiv(r, STAGE_ROWS) for r in rows)
    groups = min(tiles, max(1, _cdiv(CARD_SMS, row_blocks)))
    qkv_tiles = _cdiv(tiles, groups)
    groups = _cdiv(tiles, qkv_tiles)
    phases = {QKV: [], ATTN: [], TAIL: []}  # (last, first, stream, idx, g)
    for s in (0, 1):
        def span(r0, r1):
            return (r1 - 1) // seq[s], r0 // seq[s]
        for rb in range(_cdiv(rows[s], STAGE_ROWS)):
            last, first = span(rb * STAGE_ROWS,
                               min(rows[s], (rb + 1) * STAGE_ROWS))
            phases[QKV] += [(last, first, s, rb, g) for g in range(groups)]
        if seq[s] <= SMALL_N:
            per, per_img = UNITS_SMALL, num_heads
        else:
            per = UNITS_ROWS
            per_img = num_heads * _cdiv(seq[s], ATTN_QUERIES[dtype])
        units = b * per_img
        for u in range(0, units, per):
            phases[ATTN].append(((min(units, u + per) - 1) // per_img,
                                 u // per_img, s, u, 0))
        for rb in range(_cdiv(rows[s], tail_rows)):
            last, first = span(rb * tail_rows,
                               min(rows[s], (rb + 1) * tail_rows))
            phases[TAIL].append((last, first, s, rb, 0))
    counts = np.zeros((3, b), np.int32)
    for kind, its in phases.items():
        its.sort()
        for last, first, *_ in its:
            counts[kind, first:last + 1] += 1
    items = [(kind, j, s, idx, g, first, last, WAITS_ON[kind],
              j if kind == QKV else j + 1)
             for j in range(nb) for kind in (QKV, ATTN, TAIL)
             for last, first, s, idx, g in phases[kind]]
    items = np.asarray(items, np.int32).reshape(-1, len(STAGE_FIELDS))
    items.setflags(write=False)
    counts.setflags(write=False)
    return items, counts, qkv_tiles


_DEVICE_SCHEDULES = {}


def _device_schedule(nb, b, n, m, ch, num_heads, dtype, device):
    """stage_schedule's tables on ``device``, copied once per shape."""
    key = (nb, b, n, m, ch, num_heads, dtype, device)
    if key not in _DEVICE_SCHEDULES:
        items, counts, qkv_tiles = stage_schedule(nb, b, n, m, ch, num_heads,
                                                  dtype)
        _DEVICE_SCHEDULES[key] = (
            torch.from_numpy(items.copy()).to(device),
            torch.from_numpy(counts.copy()).to(device), qkv_tiles)
    return _DEVICE_SCHEDULES[key]


def stage_takes(n: int, m: int, ch: int, num_heads: int, n_blocks: int,
                cpes=None) -> bool:
    """Whether a stage of ``n_blocks`` S blocks goes to ``s_stage``: the
    JAX package's ``pallas_block.s_stage`` declines (returns None) for fewer
    than 2 blocks, more than 1024 image tokens, C not divisible by the
    heads, M not a multiple of 8, or blocks of which some have a CPE and
    others not (``cpes`` given with a None in it)."""
    return (n_blocks >= 2 and n <= MAX_N_STAGE and ch % num_heads == 0
            and m % 8 == 0
            and (cpes is None or all(cp is not None for cp in cpes)))


# ---------------------------------------------------------------- CUDA


def _check_cpe(name: str, x, cpe, img_w: int) -> None:
    """Raise unless ``cpe`` is the (taps (9, C), bias (C,)) pair of x's
    channels, and x's N tokens whole rows of images img_w wide."""
    ch, n = x.shape[-1], x.shape[1]
    taps, bias = cpe
    if tuple(taps.shape) != (9, ch) or tuple(bias.shape) != (ch,):
        raise ValueError(f"{name}: CPE taps (9, {ch}) and bias ({ch},) "
                         f"expected, got {tuple(taps.shape)} and "
                         f"{tuple(bias.shape)}")
    if img_w <= 0 or n % img_w:
        raise ValueError(f"{name}: N={n} tokens are not whole rows of an "
                         f"image {img_w} wide")


def _check(name: str, x, c, params: Sequence[torch.Tensor], num_heads: int,
           hidden: int, cpe=None, img_w: int = 0) -> None:
    """Raise on what the kernel does not take. ``cpe``: the (taps, bias)
    pair the kernel applies to x, images img_w wide."""
    if cpe is not None:
        _check_cpe(name, x, cpe, img_w)
        params = [*params, *cpe]
    if x.dim() != 3 or c.dim() != 3 or x.shape[0] != c.shape[0] \
            or x.shape[2] != c.shape[2]:
        raise ValueError(f"{name}: x (B,N,C) and c (B,M,C) expected, got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    ch = x.shape[2]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16 expected, got {x.dtype}")
    if ch != num_heads * HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {HEAD_DIM}; "
                         f"C={ch} with {num_heads} heads")
    if ch > MAX_DIM:
        raise ValueError(f"{name}: C={ch} exceeds the kernel's {MAX_DIM}")
    if hidden % 32:
        raise ValueError(f"{name}: MLP width {hidden} is not a multiple of 32")
    for i, t in enumerate((x, c, *params)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: tensor {i} is on {t.device}, "
                             f"expected {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: tensor {i} is {t.dtype}, "
                            f"expected {x.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor {i} is not contiguous and "
                             "16-byte aligned")


def block_takes(attn_type: str, ch: int, num_heads: int, hidden: int,
                m: int, dtype) -> bool:
    """Whether the inference kernel of an ``attn_type`` block of width
    ``ch`` with ``num_heads`` heads, MLP width ``hidden`` and ``m`` meta
    tokens takes them in ``dtype``: the limits ``_check`` and
    ``check_meta`` raise on (head_dim HEAD_DIM, C <= MAX_DIM, the MLP width
    a multiple of 32, fp32 or bf16, and for a D or D2 block at most
    ``attn/dca.py``'s MAX_META[dtype] meta tokens), decided from shapes
    alone, so it runs without CUDA. Where it says no, the model composes in
    PyTorch, as the JAX package does where its kernels return None."""
    from lemevit_tpu_torch.attn import dca
    return (dtype in _DTYPES and ch == num_heads * HEAD_DIM
            and ch <= MAX_DIM and hidden % 32 == 0
            and (attn_type not in ("D", "D2") or m <= dca.MAX_META[dtype]))


def check_meta(name: str, m: int, dtype) -> None:
    """Raise for more meta tokens than the D kernels stage (an image's meta
    rows sit in shared memory beside its image rows: attn/dca.py's
    MAX_META)."""
    from lemevit_tpu_torch.attn import dca
    if m > dca.MAX_META[dtype]:
        raise ValueError(f"{name}: the kernel takes at most "
                         f"{dca.MAX_META[dtype]} meta tokens in {dtype} "
                         f"(attn/dca.py MAX_META), got {m}")


def _check_shapes(name, params, shapes) -> None:
    for i, (t, s) in enumerate(zip(params, shapes)):
        if tuple(t.shape) != tuple(s):
            raise ValueError(f"{name}: parameter {i} has shape "
                             f"{tuple(t.shape)}, expected {tuple(s)}")


def _launch(name: str, x: torch.Tensor, tensors, *scalars,
            counts=LAUNCHES) -> None:
    """Run entry point lm_<name> on x's device and stream in x's dtype and
    add one to counts[name]."""
    from lemevit_tpu_torch.attn import _build
    lib = _build.library()
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors])
    _build.launch(lib, name, x.device, _DTYPES[x.dtype], ptrs, *scalars,
                  counts=counts)


def dca_partials(b, h, m, n, like):
    """k_dca_tc's per-tile partials of the c direction (attn_tc.cuh: max,
    sum and 32 sums per (image, head, tile of image rows, meta query)), as
    three views of one fp32 workspace."""
    from lemevit_tpu_torch.attn import dca
    tile = dca.TILE[like.dtype]
    part = dca.workspace(b, h, m, n, tile, like.device)
    rows = dca.workspace_rows(b, h, m, n, tile)
    return [part[:rows], part[rows:2 * rows], part[2 * rows:]]


def c_block(x, c, params, *, num_heads: int, cpe=None,
            img_w: int = 0) -> torch.Tensor:
    """Fused C block; see the module docstring. params = (ln1_w, ln1_b, Wq,
    bq, Wkv, bkv, Wproj, bproj, ln2_w, ln2_b, W1, b1, W2, b2)."""
    if not x.is_cuda:
        return c_block_plain(x, c, params, num_heads=num_heads, cpe=cpe,
                             img_w=img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    hidden = params[10].shape[0]
    _check("c_block", x, c, params, num_heads, hidden, cpe, img_w)
    _check_shapes("c_block", params, [
        (ch,), (ch,), (ch, ch), (ch,), (2 * ch, ch), (2 * ch,), (ch, ch),
        (ch,), (ch,), (ch,), (hidden, ch), (hidden,), (ch, hidden), (ch,)])
    ws = dict(dtype=x.dtype, device=x.device)
    co = torch.empty_like(c)
    work = [torch.empty(b * m, ch, **ws), torch.empty(b * n, 2 * ch, **ws),
            torch.empty(b * m, ch, **ws),
            *dca_partials(b, num_heads, m, n, x)]
    _launch("c_block", x, [x, c, *params, co, *work, *_cpe_ptrs(cpe)], b, n,
            m, ch, num_heads, hidden, img_w, HEAD_DIM ** -0.5, LN_EPS)
    return co


def _cpe_ptrs(cpe):
    """The (taps, bias) tensors a kernel reads, or two nulls."""
    return (None, None) if cpe is None else cpe


def _cpe_work(x, cpe):
    """The S / D kernels' workspace for x's CPE (the tail's residual), or
    a null without the CPE."""
    return None if cpe is None else torch.empty_like(x)


def dca_block(x, c, params, *, num_heads: int, scale_x: float,
              scale_c: float, cpe=None, img_w: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused D block; see the module docstring. params = (ln1_w, ln1_b,
    Wqkv1, bqkv1, Wqkv2, bqkv2, Wproj_x, bproj_x, Wproj_c, bproj_c, ln2_w,
    ln2_b, W1, b1, W2, b2)."""
    if not x.is_cuda:
        return dca_block_plain(x, c, params, num_heads=num_heads,
                               scale_x=scale_x, scale_c=scale_c, cpe=cpe,
                               img_w=img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    hidden = params[12].shape[0]
    _check("dca_block", x, c, params, num_heads, hidden, cpe, img_w)
    _check_shapes("dca_block", params, [
        (ch,), (ch,), (3 * ch, ch), (3 * ch,), (3 * ch, ch), (3 * ch,),
        (ch, ch), (ch,), (ch, ch), (ch,), (ch,), (ch,), (hidden, ch),
        (hidden,), (ch, hidden), (ch,)])
    check_meta("dca_block", m, x.dtype)
    ws = dict(dtype=x.dtype, device=x.device)
    xo = torch.empty_like(x)
    co = torch.empty_like(c)
    work = [torch.empty(b * n, 3 * ch, **ws), torch.empty(b * m, 3 * ch, **ws),
            torch.empty(b * n, ch, **ws), torch.empty(b * m, ch, **ws),
            *dca_partials(b, num_heads, m, n, x)]
    _launch("dca_block", x, [x, c, *params, xo, co, *work, *_cpe_ptrs(cpe),
                             _cpe_work(x, cpe)],
            b, n, m, ch, num_heads, hidden, img_w, scale_x, scale_c, LN_EPS)
    return xo, co


def _s_shapes(ch, hidden):
    return [(ch,), (ch,), (3 * ch, ch), (3 * ch,), (ch, ch), (ch,), (ch,),
            (ch,), (hidden, ch), (hidden,), (ch, hidden), (ch,)]


def _s_work(b, n, m, ch, like):
    """qkv and attention-output workspaces of both streams."""
    ws = dict(dtype=like.dtype, device=like.device)
    return [torch.empty(b * n, 3 * ch, **ws), torch.empty(b * m, 3 * ch, **ws),
            torch.empty(b * n, ch, **ws), torch.empty(b * m, ch, **ws)]


def s_block(x, c, params, *, num_heads: int, cpe=None, img_w: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused S block; see the module docstring. params = (ln1_w, ln1_b,
    Wqkv, bqkv, Wproj, bproj, ln2_w, ln2_b, W1, b1, W2, b2)."""
    if not x.is_cuda:
        return s_block_plain(x, c, params, num_heads=num_heads, cpe=cpe,
                             img_w=img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    hidden = params[8].shape[0]
    _check("s_block", x, c, params, num_heads, hidden, cpe, img_w)
    _check_shapes("s_block", params, _s_shapes(ch, hidden))
    xo = torch.empty_like(x)
    co = torch.empty_like(c)
    _launch("s_block", x, [x, c, *params, xo, co, *_s_work(b, n, m, ch, x),
                           *_cpe_ptrs(cpe), _cpe_work(x, cpe)],
            b, n, m, ch, num_heads, hidden, img_w, HEAD_DIM ** -0.5, LN_EPS)
    return xo, co


def s_stage(x, c, params_list, *, num_heads: int, cpes=None,
            img_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stage of fused S blocks in one launch (``csrc/s_stage.cu``); see
    the module docstring. params_list: one ``s_block`` parameter tuple per
    block; cpes: one (taps (9, C), bias (C,)) pair per block, or None. A
    CUDA call that ``stage_takes`` declines raises."""
    if not x.is_cuda:
        return s_stage_plain(x, c, params_list, num_heads=num_heads,
                             cpes=cpes, img_w=img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    nb = len(params_list)
    if not stage_takes(n, m, ch, num_heads, nb, cpes):
        raise ValueError(f"s_stage: {nb} blocks at N={n}, M={m}, C={ch}, "
                         f"{num_heads} heads are not taken (stage_takes)")
    hidden = params_list[0][8].shape[0]
    for j, params in enumerate(params_list):
        cpe = None if cpes is None else cpes[j]
        _check("s_stage", x, c, params, num_heads, hidden, cpe, img_w)
        _check_shapes("s_stage", params, _s_shapes(ch, hidden))
    items, counts, qkv_tiles = _device_schedule(nb, b, n, m, ch, num_heads,
                                                x.dtype, x.device)
    table = _stage_table(x, params_list, cpes, hidden)
    xo = torch.empty_like(x)
    co = torch.empty_like(c)
    xa = None if cpes is None else torch.empty_like(x)
    sync = torch.empty(1 + 3 * b, dtype=torch.int32, device=x.device)
    _launch("s_stage", x, [x, c, xo, co, xa, *_s_work(b, n, m, ch, x),
                           table, items, counts, sync],
            len(items), b, n, m, ch, num_heads, hidden, img_w,
            int(cpes is not None), qkv_tiles, HEAD_DIM ** -0.5, LN_EPS)
    return xo, co


def _stage_table(x, params_list, cpes, hidden) -> torch.Tensor:
    """The blocks' weight table on x's device: lm_s_stage_table writes each
    block's TMA maps and pointers into pinned host memory, copied on x's
    stream without waiting for it."""
    from lemevit_tpu_torch.attn import _build
    nb, ch = len(params_list), x.shape[-1]
    ptrs = [0 if t is None else t.data_ptr()
            for j, params in enumerate(params_list)
            for t in (*params, *_cpe_ptrs(None if cpes is None
                                          else cpes[j]))]
    host = torch.empty(nb * STAGE_BLOCK_BYTES, dtype=torch.uint8,
                       pin_memory=True)
    if host.data_ptr() % 64:
        raise RuntimeError("s_stage: the weight table is not 64-byte "
                           "aligned")
    lib = _build.library()
    _build.check(lib, lib.lm_s_stage_table(
        _DTYPES[x.dtype], (ctypes.c_void_p * len(ptrs))(*ptrs), nb, ch,
        hidden, host.numel(), host.data_ptr()), "s_stage_table")
    return host.to(x.device, non_blocking=True)
