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

``LAUNCHES[name]`` counts kernel launches of each block (one per call on
CUDA tensors; the plain versions do not count).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.attn.reference import sdpa_bnhd

LN_EPS = 1e-6          # the blocks' norm1 / norm2
HEAD_DIM = 32          # the kernels assign one lane per head channel
KEYS_PER_SPLIT = 256   # image keys per block in the meta-query direction
MAX_DIM = 640          # the tail keeps (32, C) rows on chip
MAX_N_STAGE = 1024     # lemevit_tpu/attn/pallas_block.py:38 _MAX_N_SBLOCK

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


def s_stage_plain(x, c, params_list, *, num_heads: int, cpes=None,
                  img_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stage of S blocks: ``s_block_plain`` with each block's parameters
    and CPE (``cpes[j]``, or none) in turn."""
    for j, params in enumerate(params_list):
        x, c = s_block_plain(x, c, params, num_heads=num_heads,
                             cpe=None if cpes is None else cpes[j],
                             img_w=img_w)
    return x, c


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


def _partials(b, h, m, n, device):
    splits = -(-n // KEYS_PER_SPLIT)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(b * h * splits * m, **f32),
            torch.empty(b * h * splits * m, **f32),
            torch.empty(b * h * splits * m * HEAD_DIM, **f32))


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
            *_partials(b, num_heads, m, n, x.device)]
    _launch("c_block", x, [x, c, *params, co, *work, *_cpe_ptrs(cpe)], b, n,
            m, ch, num_heads, hidden, KEYS_PER_SPLIT, img_w,
            HEAD_DIM ** -0.5, LN_EPS)
    return co


def _cpe_ptrs(cpe):
    """The (taps, bias) tensors a kernel reads, or two nulls."""
    return (None, None) if cpe is None else cpe


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
    ws = dict(dtype=x.dtype, device=x.device)
    xo = torch.empty_like(x)
    co = torch.empty_like(c)
    work = [torch.empty(b * n, 3 * ch, **ws), torch.empty(b * m, 3 * ch, **ws),
            torch.empty(b * n, ch, **ws), torch.empty(b * m, ch, **ws),
            *_partials(b, num_heads, m, n, x.device)]
    _launch("dca_block", x, [x, c, *params, xo, co, *work, *_cpe_ptrs(cpe)],
            b, n, m, ch, num_heads, hidden, KEYS_PER_SPLIT, img_w, scale_x,
            scale_c, LN_EPS)
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
                           *_cpe_ptrs(cpe)],
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
    blocks = [t for j, params in enumerate(params_list)
              for t in (*params, *_cpe_ptrs(None if cpes is None
                                            else cpes[j]))]
    # the blocks' pointers, copied from pinned memory on x's stream
    table = torch.tensor([0 if t is None else t.data_ptr() for t in blocks],
                         dtype=torch.int64).pin_memory().to(
                             x.device, non_blocking=True)
    xo = torch.empty_like(x)
    co = torch.empty_like(c)
    xa = None if cpes is None else torch.empty_like(x)
    _launch("s_stage", x, [x, c, xo, co, xa, *_s_work(b, n, m, ch, x),
                           table],
            nb, b, n, m, ch, num_heads, hidden, img_w, int(cpes is not None),
            HEAD_DIM ** -0.5, LN_EPS)
    return xo, co
