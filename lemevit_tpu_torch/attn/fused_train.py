"""Training kernels of the pre-norm LeMeViT blocks: counterpart of
lemevit_tpu/attn/pallas_train.py's s_block_train, dca_block_train and
c_block_train (custom VJPs around the Pallas training kernels).

  s_block_train(x, c, params, dp, *, num_heads, cpe=None, img_w=0)
                                                -> (x_out, c_out)
  dca_block_train(x, c, params, dp, *, num_heads, scale_x, scale_c,
                  cpe=None, img_w=0)            -> (x_out, c_out)
  c_block_train(x, c, params, dp, *, num_heads, cpe=None, img_w=0) -> c_out

x is (B, N, C) image tokens and c (B, M, C) meta tokens. Without ``cpe``, x
comes *after* the conditional position embedding (the CPE stays outside, a
depthwise ``F.conv2d`` under autograd, as the JAX package's default
``PB_TRAIN_CPE=ext``). With ``cpe = (taps (9, C) in (ky, kx) order, bias
(C,))`` x comes *before* it, from images ``img_w`` wide, and the kernels
apply the 3x3 CPE themselves (JAX's ``PB_TRAIN_CPE=fused``): the forward
runs the block on x + b + sum_9 tap[ky, kx] x[i + (ky-1) W + (kx-1)] (the C
block on its k / v side only), the backward recomputes it from the saved
pre-CPE x, and the Functions also return the taps' and the bias's
gradients. ``params`` are LN-folded
tuples in torch ``nn.Linear`` layout: ``fold_ln`` folds norm1 into the
attention's input projections and norm2 into fc1 *outside* the autograd
Function, so autograd chains the LayerNorm gamma / beta gradients.
  S    (Wqkv', bqkv', Wp, bp, W1', b1', W2, b2)
  D    (Wqkv1', bqkv1', Wqkv2', bqkv2', Wpx, bpx, Wpc, bpc, W1', b1', W2, b2);
       D2 blocks pass [Wq|Wq|Wv1] / [Wk|Wk|Wv2] here (LeMeBlock.fused_params)
  C    (Wq', bq', Wkv', bkv', Wp, bp, W1', b1', W2, b2); the C block returns
       c only, and x gets gradients through k / v
``dp`` is the (4, B) fp32 table of per-image DropPath branch scales
(s1x, s2x, s1c, s2c): keep_mask / keep, applied to the whole branch
including its bias (timm semantics); it gets no gradient. The D scales are
reference.dca_scales' (log_N(M) C^-1/2 and C^-1/2), the S and C scale
head_dim^-1/2.

Each Function runs explicit phases, each a hand-written kernel chain on CUDA
tensors (``csrc/s_train.cu``, ``dca_train.cu``, ``c_train.cu``) and its
plain PyTorch version on CPU tensors:
  s_train_fwd / dca_train_fwd   the forward; also returns t1 (the
                                post-attention residual), the attention
                                outputs o and each query's log-sum-exp
  c_train_fwd                   the same on the meta stream only
  mlp_bwd      (t1, upstream grads) -> dt1, dW1, db1, dW2, db2; the C block
               runs it with an empty image stream
  s_attn_bwd / dca_attn_bwd / c_attn_bwd
               (x, c, dt1, o, lse) -> the data and attention weight grads
The weight gradients accumulate in fp32 and are returned in the parameters'
dtype. With a CPE the attention backward takes the gradient at the CPE's
output in fp32 and gives the tap and bias gradients (cpe_tap_grads_plain)
and dx through the CPE's transpose: the same CPE with the taps flipped
(tap 8 - j for tap j) and no bias (cpe_rows_plain). ``*_block_train_plain``
is each block composed under autograd: the reference the phases are tested
against. The plain phases take head_dim from the shapes; the kernels take
head_dim 32 (``train_takes`` states every limit of the training kernels,
from shapes alone: the model asks it under ``attn_backend="auto"`` and
composes where it says no; a direct call raises).
``s_train_fwd_tiles_plain``, ``dca_train_fwd_tiles_plain``,
``c_train_fwd_tiles_plain``, ``mlp_bwd_tiles_plain``,
``s_attn_bwd_tiles_plain``, ``dca_attn_bwd_tiles_plain`` and
``c_attn_bwd_tiles_plain`` are the order of work of the phases on the
tensor cores (csrc/block_tc.cuh, attn_tc.cuh and train_tc.cuh: their
roundings, the weight gradients over the launch's row ranges), which the
tests hold the bf16 kernels against.

``LAUNCHES[name]`` counts kernel launches of each phase (one per call on CUDA
tensors; the plain versions do not count).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import sdpa_bnhd

LN_EPS = fb.LN_EPS
LAUNCHES = {"s_train_fwd": 0, "mlp_bwd": 0, "s_attn_bwd": 0,
            "dca_train_fwd": 0, "dca_attn_bwd": 0, "c_train_fwd": 0,
            "c_attn_bwd": 0}
WGRAD_TC_TILE = 128     # k_wgrad_tc's output tile edge
CPE_GRAD_ROWS = 64      # least rows per k_cpe_tap_grads block
# image rows of one k_dca_bwd_tc chunk (csrc/train_tc.cuh, DcaBwdTile; the
# C and D blocks alike)
DCA_BWD_ROWS = {torch.bfloat16: 128, torch.float32: 64}
MAX_TRAIN_DIM = 512     # the row kernels of every MLP backward and of the S
                        # attention backward (csrc/train_tc.cuh) keep a
                        # (64 x C) fp32 sum in registers at C's accumulator
                        # tier (block_tc.cuh::by_tier, C <= 512)


def fold_ln(gamma, beta, w, b):
    """LN(t) W^T + b == norm(t) W'^T + b' with W' = W diag(gamma),
    b' = b + W beta (lemevit_tpu/attn/pallas_block.py::_fold_ln, torch
    layout). Elementwise and a row sum, so autocast leaves it in fp32."""
    return w * gamma, b + (w * beta).sum(dim=1)


# ---------------------------------------------------------------- plain


def _norm(t):
    """Scale/bias-free LayerNorm with fp32 statistics, in fp32."""
    return F.layer_norm(t.float(), (t.shape[-1],), eps=LN_EPS)


def _ln_bwd(g, t):
    """Backward of the scale/bias-free LayerNorm: g is the fp32 gradient of
    norm(t); statistics recomputed from t."""
    th = _norm(t)
    t32 = t.float()
    inv = torch.rsqrt(t32.var(-1, unbiased=False, keepdim=True) + LN_EPS)
    return inv * (g - g.mean(-1, keepdim=True)
                  - th * (g * th).mean(-1, keepdim=True))


def _gelu_grad(y):
    """d GELU(y) / dy, exact-erf form, fp32."""
    return (0.5 * (1.0 + torch.erf(y * 0.5 ** 0.5))
            + y * torch.exp(-0.5 * y * y) * (2 * math.pi) ** -0.5)


def _col(s, t):
    """Per-image scale s (B,) as a column broadcasting over t (B, n, C)."""
    return s.view(-1, *([1] * (t.dim() - 1)))


def _heads(t, h):
    """(B, n, C) -> (B, n, h, C / h) in fp32."""
    return t.float().unflatten(-1, (h, -1))


def _attn_fwd(q, k, v, h, scale):
    """Softmax attention of q (B, nq, C) over k / v (B, nk, C) with h heads:
    (o (B, nq, C), lse (B, h, nq)), both fp32."""
    q, k, v = (_heads(t, h) for t in (q, k, v))
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhnm,bmhd->bnhd", p, v).flatten(2), lse


def _attn_bwd(q, k, v, o, d_o, lse, h, scale):
    """Backward of _attn_fwd from its log-sum-exp (P rebuilt, dS = P (dO
    v^T - rowsum(dO o))): (dq, dk, dv) fp32, shaped as q, k, v."""
    q, k, v, o, d_o = (_heads(t, h) for t in (q, k, v, o, d_o))
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
                  - lse[..., None])
    rowdot = (d_o * o).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bnhd,bmhd->bhnm", d_o, v) - rowdot[..., None])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, d_o)
    return dq.flatten(2), dk.flatten(2), dv.flatten(2)


def _tail(t, o, wp, bp, s1, s2, w1, b1, w2, b2):
    """One stream's block tail in fp32, rounded as the kernels round:
    t1 = t + s1 (o Wp^T + bp), out = t1 + s2 MLP(norm(t1)). Returns (out,
    t1) in t's dtype."""
    dt = t.dtype
    t1 = t.float() + _col(s1, t) * F.linear(o, wp, bp).float()
    g = F.gelu(F.linear(_norm(t1).to(dt), w1, b1).float()).to(dt)
    out = t1 + _col(s2, t) * F.linear(g, w2, b2).float()
    return out.to(dt), t1.to(dt)


def _wgrad(g, a):
    """G^T A over every token row, fp32: the weight gradient of a Linear
    with input a and output gradient g."""
    return g.reshape(-1, g.shape[-1]).float().t() @ a.reshape(
        -1, a.shape[-1]).float()


def _colsum(g):
    return g.float().reshape(-1, g.shape[-1]).sum(0)


def _dproj(s1, dt1):
    """s1 dt1: the gradient of a DropPath-scaled projection, in dt1's
    dtype (the product in fp32, rounded once: one elementwise kernel)."""
    return torch.mul(dt1, _col(s1, dt1), out=torch.empty_like(dt1))


def s_train_fwd_plain(x, c, params, dp, *, num_heads: int, cpe=None,
                      img_w: int = 0):
    """Forward of both streams: (x_out, c_out, t1x, t1c, o_x, o_c, lse_x,
    lse_c); lse is (B, H, n) fp32, the rest in x's dtype. With ``cpe`` x is
    the pre-CPE tokens."""
    wqkv, bqkv, wp, bp, w1, b1, w2, b2 = params
    if cpe is not None:
        x = cpe_rows_plain(x, *cpe, img_w)
    dt = x.dtype
    scale = (x.shape[-1] // num_heads) ** -0.5

    def branch(t, s1, s2):
        q, k, v = F.linear(_norm(t).to(dt), wqkv, bqkv).chunk(3, -1)
        o, lse = _attn_fwd(q, k, v, num_heads, scale)
        out, t1 = _tail(t, o.to(dt), wp, bp, s1, s2, w1, b1, w2, b2)
        return out, t1, o.to(dt), lse

    xo, t1x, ox, lx = branch(x, dp[0], dp[1])
    co, t1c, oc, lc = branch(c, dp[2], dp[3])
    return xo, co, t1x, t1c, ox, oc, lx, lc


def _mlp_bwd_streams(t1x, t1c, dxo, dco, dp, w1, b1, w2):
    """Both streams of the MLP backward, rounded where the kernels round:
    (dt1x, dt1c, [(dy, LN2(t1)), ...], [(dz, GELU(y)), ...]), the pairs
    being the weight gradients' operands of each non-empty stream (dz = s2
    dout, LN2(t1), dy and GELU(y) in t1's dtype, the sums in fp32)."""
    dt = t1x.dtype
    w1f, w2f = w1.float(), w2.float()
    dt1s, p1, p2 = [], [], []
    for t1, dout, s2 in ((t1x, dxo, dp[1]), (t1c, dco, dp[3])):
        if not t1.numel():  # an empty stream (the C block's image tokens)
            dt1s.append(torch.empty_like(t1))
            continue
        ch = t1.shape[-1]
        dz = _dproj(s2, dout).reshape(-1, ch)
        t1f = t1.reshape(-1, ch)
        mm = _norm(t1f).to(dt)
        y = mm.float() @ w1f.t() + b1.float()
        dy = ((dz.float() @ w2f) * _gelu_grad(y)).to(dt)
        dt1 = dout.reshape(-1, ch).float() + _ln_bwd(dy.float() @ w1f, t1f)
        dt1s.append(dt1.to(dt).reshape(t1.shape))
        p1.append((dy, mm))
        p2.append((dz, F.gelu(y).to(dt)))
    return dt1s[0], dt1s[1], p1, p2


def mlp_bwd_plain(t1x, t1c, dxo, dco, dp, w1, b1, w2):
    """MLP backward of both streams (the TPU's _mlp_bwd_call): returns
    (dt1x, dt1c, dW1, db1, dW2, db2), weight gradients summed over both
    streams in fp32 and returned in the weights' dtype."""
    dt1x, dt1c, p1, p2 = _mlp_bwd_streams(t1x, t1c, dxo, dco, dp, w1, b1, w2)
    dw1 = sum(_wgrad(g, a) for g, a in p1)
    dw2 = sum(_wgrad(g, a) for g, a in p2)
    db1 = sum(_colsum(g) for g, _ in p1)
    db2 = sum(_colsum(g) for g, _ in p2)
    return (dt1x, dt1c, dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(w2.dtype))


def s_attn_bwd_plain(x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox, oc, lse_x,
                     lse_c, *, num_heads: int, cpe=None, img_w: int = 0):
    """Attention backward of both streams (the TPU's _s_attn_bwd_kernel):
    returns (dx, dc, dWqkv, dbqkv, dWp, dbp, dtaps, dbias). LN1 and qkv are
    recomputed (with ``cpe``, on the CPE of the pre-CPE x), P is rebuilt
    from the forward's log-sum-exp; dtaps and dbias are None without a
    CPE."""
    dt = x.dtype
    scale = (x.shape[-1] // num_heads) ** -0.5
    xc = x if cpe is None else cpe_rows_plain(x, *cpe, img_w)
    acc = [0.0, 0.0, 0.0, 0.0]
    grads = []
    for t, dt1, s1, o, lse in ((xc, dt1x, dp[0], ox, lse_x),
                               (c, dt1c, dp[2], oc, lse_c)):
        dproj = _dproj(s1, dt1)
        a = _norm(t).to(dt)
        q, k, v = F.linear(a, wqkv, bqkv).chunk(3, -1)
        dqkv = torch.cat(_attn_bwd(q, k, v, o, dproj.float() @ wp.float(),
                                   lse, num_heads, scale), -1).to(dt)
        grads.append(dt1.float() + _ln_bwd(dqkv.float() @ wqkv.float(), t))
        for i, val in enumerate((_wgrad(dqkv, a), _colsum(dqkv),
                                 _wgrad(dproj, o), _colsum(dproj))):
            acc[i] = acc[i] + val
    dx, dtaps, dbias = ((grads[0].to(dt), None, None) if cpe is None
                        else _cpe_bwd_plain(x, grads[0], cpe, img_w))
    return (dx, grads[1].to(dt), acc[0].to(wqkv.dtype),
            acc[1].to(bqkv.dtype), acc[2].to(wp.dtype), acc[3].to(wp.dtype),
            dtaps, dbias)


def _tiles_rows(x, rows0: int, rows1: int, shapes) -> int:
    """A tile model's rows per weight-gradient range: k_wgrad_tc's split on
    CUDA tensor x's device."""
    if not x.is_cuda:
        raise ValueError("rows_per_split is required for CPU tensors")
    return _wgrad_tc_split(rows0, rows1, shapes, _sms(x.device))[0]


def _wgrad_ranges(pairs, rows_per_split: int):
    """(sum of G^T A, sum of colsum G) in fp32 over consecutive ranges of
    rows_per_split rows of each (G, A) stream pair in turn, added in that
    order from zero: k_wgrad_tc's partials as k_wgrad_tc_reduce sums
    them."""
    dw = db = 0.0
    for g, a in pairs:
        for r in range(0, g.shape[0], rows_per_split):
            gr, ar = g[r:r + rows_per_split], a[r:r + rows_per_split]
            dw = dw + _wgrad(gr, ar)
            db = db + _colsum(gr)
    return dw, db


def mlp_bwd_tiles_plain(t1x, t1c, dxo, dco, dp, w1, b1, w2, *,
                        rows_per_split: int = 0):
    """lm_mlp_bwd's order of work in PyTorch (used by the tests only): per
    stream LN2(t1) rounded to t1's dtype; y = LN2(t1) W1'^T + b1' and dgg =
    dz W2 (dz = s2 dout, rounded) in fp32; dy = dgg GELU'(y) and GELU(y)
    rounded (k_mlp_bwd_wg takes the hidden width 64 columns at a time; the
    roundings are per element, so the chunks need no loop here); d(LN2) =
    dy W1' in fp32 and dt1 = dout + LN2'(t1)^T d(LN2) rounded, as
    mlp_bwd_plain rounds them. The weight gradients sum in fp32 over row
    ranges of ``rows_per_split`` rows (on CUDA tensors by default the
    launch's split on their device; required on the CPU), the image
    stream's first, and are rounded once. In fp32 nothing rounds."""
    b, n, ch = t1x.shape
    hidden = w1.shape[0]
    rps = rows_per_split or _tiles_rows(
        t1x, b * n, b * t1c.shape[1], [(hidden, ch), (ch, hidden)])
    dt1x, dt1c, p1, p2 = _mlp_bwd_streams(t1x, t1c, dxo, dco, dp, w1, b1, w2)
    dw1, db1 = _wgrad_ranges(p1, rps)
    dw2, db2 = _wgrad_ranges(p2, rps)
    return (dt1x, dt1c, dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(w2.dtype))


def _attn_bwd_tiles(q, k, v, o, d_o, lse, h, scale, dt):
    """train_tc.cuh's attention backward: P = exp(q k^T scale - lse) in
    fp32, D = rowsum(dO . o) from the rounded dO, dS = P (dO v^T - D) scale
    rounded to dt, dq = dS k, dk = dS^T q, dv = P^T dO with P rounded; fp32
    sums, (dq, dk, dv) fp32 shaped as q, k, v."""
    q, k, v, o, d_o = (_heads(t, h) for t in (q, k, v, o, d_o))
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
                  - lse[..., None])
    rowdot = (d_o * o).sum(-1).permute(0, 2, 1)
    ds = (p * (torch.einsum("bnhd,bmhd->bhnm", d_o, v) - rowdot[..., None])
          * scale).to(dt).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q)
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dt).float(), d_o)
    return dq.flatten(2), dk.flatten(2), dv.flatten(2)


def s_attn_bwd_tiles_plain(x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox, oc,
                           lse_x, lse_c, *, num_heads: int, cpe=None,
                           img_w: int = 0, rows_per_split: int = 0):
    """lm_s_attn_bwd's order of work in PyTorch (used by the tests only):
    LN1 (of the CPE'd x, rounded once, with ``cpe``) rounded to x's dtype,
    qkv rounded, dO = dproj Wp rounded, the attention backward as
    _attn_bwd_tiles (head_dim 32, as the kernels), dqkv rounded, dx = dt1 +
    LN1'^T (dqkv Wqkv') from fp32 sums (with ``cpe`` kept in fp32 for the
    CPE's backward, _cpe_bwd_plain), and the weight gradients over row
    ranges as mlp_bwd_tiles_plain's. In fp32 nothing rounds."""
    dt = x.dtype
    b, n, ch = x.shape
    m = c.shape[1]
    rps = rows_per_split or _tiles_rows(x, b * n, b * m,
                                        [(3 * ch, ch), (ch, ch)])
    scale = fb.HEAD_DIM ** -0.5
    xc = x if cpe is None else cpe_rows_plain(x, *cpe, img_w)
    grads, pq, pp = [], [], []
    for t, dt1, s1, o, lse in ((xc, dt1x, dp[0], ox, lse_x),
                               (c, dt1c, dp[2], oc, lse_c)):
        dproj = _dproj(s1, dt1)
        a = _norm(t).to(dt)
        q, k, v = (a.float() @ wqkv.float().t()
                   + bqkv.float()).to(dt).chunk(3, -1)
        d_o = (dproj.float() @ wp.float()).to(dt)
        dqkv = torch.cat(_attn_bwd_tiles(q, k, v, o, d_o, lse, num_heads,
                                         scale, dt), -1).to(dt)
        grads.append(dt1.float() + _ln_bwd(dqkv.float() @ wqkv.float(), t))
        pq.append((dqkv.reshape(-1, 3 * ch), a.reshape(-1, ch)))
        pp.append((dproj.reshape(-1, ch), o.reshape(-1, ch)))
    dwqkv, dbqkv = _wgrad_ranges(pq, rps)
    dwp, dbp = _wgrad_ranges(pp, rps)
    dx, dtaps, dbias = ((grads[0].to(dt), None, None) if cpe is None
                        else _cpe_bwd_plain(x, grads[0], cpe, img_w))
    return (dx, grads[1].to(dt), dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
            dwp.to(wp.dtype), dbp.to(wp.dtype), dtaps, dbias)


def s_train_fwd_tiles_plain(x, c, params, dp, *, num_heads: int, cpe=None,
                            img_w: int = 0):
    """lm_s_train_fwd's order of work in PyTorch (used by the tests only):
    with ``cpe`` the CPE'd x rounded once (k_cpe_rows); per stream LN1
    rounded to x's dtype and qkv = LN1 Wqkv'^T + b in fp32 rounded
    (k_qkv_wg); o as ``attn/mhsa.py::mhsa_tiles_plain`` (k_mhsa_tc's 32-key
    online-softmax steps, P rounded before P v) and each query's
    log-sum-exp of the scaled scores of the rounded q, k in fp32; the tail
    as k_tail_wg's training instance (fused_block._tail_tiles with the
    branch scales: t1 rounded as written, s2 GELU(fc1) rounded per hidden
    chunk). Returns what s_train_fwd_plain returns. In fp32 nothing
    rounds."""
    from lemevit_tpu_torch.attn.mhsa import mhsa_tiles_plain
    wqkv, bqkv, wp, bp, w1, b1, w2, b2 = params
    dt = x.dtype
    if cpe is not None:
        x = cpe_rows_plain(x, *cpe, img_w)
    scale = fb.HEAD_DIM ** -0.5

    def branch(t, s1, s2):
        q, k, v = fb._qkv_tiles(t, None, None, wqkv, bqkv, dt).chunk(3, -1)
        o = mhsa_tiles_plain(q, k, v, scale=scale, num_heads=num_heads)
        lse = torch.logsumexp(torch.einsum(
            "bnhd,bmhd->bhnm", _heads(q, num_heads), _heads(k, num_heads))
            * scale, dim=-1)
        out, t1 = fb._tail_tiles(t, o, wp, bp, None, None, w1, b1, w2, b2,
                                 dt, s1, s2)
        return out, t1, o, lse

    xo, t1x, ox, lx = branch(x, dp[0], dp[1])
    co, t1c, oc, lc = branch(c, dp[2], dp[3])
    return xo, co, t1x, t1c, ox, oc, lx, lc


def dca_train_fwd_plain(x, c, params, dp, *, num_heads: int, scale_x: float,
                        scale_c: float, cpe=None, img_w: int = 0):
    """D-block forward (the TPU's _dca_train_fwd_kernel): (x_out, c_out,
    t1x, t1c, o_x, o_c, lse_x, lse_c); lse is (B, H, n) fp32, the rest in
    x's dtype. With ``cpe`` x is the pre-CPE tokens."""
    wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc, w1, b1, w2, b2 = params
    if cpe is not None:
        x = cpe_rows_plain(x, *cpe, img_w)
    dt = x.dtype
    q1, k1, v1 = F.linear(_norm(x).to(dt), wqkv1, bqkv1).chunk(3, -1)
    q2, k2, v2 = F.linear(_norm(c).to(dt), wqkv2, bqkv2).chunk(3, -1)
    ox, lx = _attn_fwd(q1, k2, v2, num_heads, scale_x)
    oc, lc = _attn_fwd(q2, k1, v1, num_heads, scale_c)
    ox, oc = ox.to(dt), oc.to(dt)
    xo, t1x = _tail(x, ox, wpx, bpx, dp[0], dp[1], w1, b1, w2, b2)
    co, t1c = _tail(c, oc, wpc, bpc, dp[2], dp[3], w1, b1, w2, b2)
    return xo, co, t1x, t1c, ox, oc, lx, lc


def dca_train_fwd_tiles_plain(x, c, params, dp, *, num_heads: int,
                              scale_x: float, scale_c: float, cpe=None,
                              img_w: int = 0):
    """lm_dca_train_fwd's order of work in PyTorch (used by the tests only):
    with ``cpe`` the CPE'd x rounded once (k_qkv_wg's cpe mode, the tail's
    residual); per stream LN1 rounded to x's dtype and qkv = LN1 Wqkv'^T +
    b in fp32 rounded (k_qkv_wg, each stream its weights); both directions
    as ``attn/dca.py::dca_tiles_plain`` with their log-sum-exps (k_dca_tc
    and k_dca_merge's kLse instance); the tails as k_tail_wg's training
    instance (fused_block._tail_tiles with the branch scales). Returns what
    dca_train_fwd_plain returns. In fp32 nothing rounds."""
    from lemevit_tpu_torch.attn.dca import dca_tiles_plain
    wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc, w1, b1, w2, b2 = params
    dt = x.dtype
    x = fb._cpe_rounded(x, cpe, img_w)
    q1, k1, v1 = fb._qkv_tiles(x, None, None, wqkv1, bqkv1, dt).chunk(3, -1)
    q2, k2, v2 = fb._qkv_tiles(c, None, None, wqkv2, bqkv2, dt).chunk(3, -1)
    ox, oc, lx, lc = dca_tiles_plain(q1, k1, v1, q2, k2, v2, scale_x=scale_x,
                                     scale_c=scale_c, num_heads=num_heads,
                                     lse=True)
    xo, t1x = fb._tail_tiles(x, ox, wpx, bpx, None, None, w1, b1, w2, b2, dt,
                             dp[0], dp[1])
    co, t1c = fb._tail_tiles(c, oc, wpc, bpc, None, None, w1, b1, w2, b2, dt,
                             dp[2], dp[3])
    return xo, co, t1x, t1c, ox, oc, lx, lc


def dca_attn_bwd_plain(x, c, dt1x, dt1c, dp, wqkv1, bqkv1, wqkv2, bqkv2,
                       wpx, wpc, ox, oc, lse_x, lse_c, *, num_heads: int,
                       scale_x: float, scale_c: float, cpe=None,
                       img_w: int = 0):
    """D-block attention backward (the TPU's _dca_attn_bwd_kernel): returns
    (dx, dc, dWqkv1, dbqkv1, dWqkv2, dbqkv2, dWpx, dbpx, dWpc, dbpc, dtaps,
    dbias). The x direction's dq lands in dqkv1, its dk / dv in dqkv2, and
    the c direction's the other way round. With ``cpe`` x is the pre-CPE
    tokens; dtaps and dbias are None without one."""
    dt = x.dtype
    xc = x if cpe is None else cpe_rows_plain(x, *cpe, img_w)
    dpx, dpc = _dproj(dp[0], dt1x), _dproj(dp[2], dt1c)
    ax, ac = _norm(xc).to(dt), _norm(c).to(dt)
    q1, k1, v1 = F.linear(ax, wqkv1, bqkv1).chunk(3, -1)
    q2, k2, v2 = F.linear(ac, wqkv2, bqkv2).chunk(3, -1)
    dq1, dk2, dv2 = _attn_bwd(q1, k2, v2, ox, dpx.float() @ wpx.float(),
                              lse_x, num_heads, scale_x)
    dq2, dk1, dv1 = _attn_bwd(q2, k1, v1, oc, dpc.float() @ wpc.float(),
                              lse_c, num_heads, scale_c)
    dqkv1 = torch.cat([dq1, dk1, dv1], -1).to(dt)
    dqkv2 = torch.cat([dq2, dk2, dv2], -1).to(dt)
    dx = dt1x.float() + _ln_bwd(dqkv1.float() @ wqkv1.float(), xc)
    dc = dt1c.float() + _ln_bwd(dqkv2.float() @ wqkv2.float(), c)
    dx, dtaps, dbias = ((dx.to(dt), None, None) if cpe is None
                        else _cpe_bwd_plain(x, dx, cpe, img_w))
    return (dx, dc.to(dt),
            _wgrad(dqkv1, ax).to(wqkv1.dtype),
            _colsum(dqkv1).to(bqkv1.dtype),
            _wgrad(dqkv2, ac).to(wqkv2.dtype),
            _colsum(dqkv2).to(bqkv2.dtype),
            _wgrad(dpx, ox).to(wpx.dtype), _colsum(dpx).to(wpx.dtype),
            _wgrad(dpc, oc).to(wpc.dtype), _colsum(dpc).to(wpc.dtype),
            dtaps, dbias)


def dca_attn_bwd_tiles_plain(x, c, dt1x, dt1c, dp, wqkv1, bqkv1, wqkv2,
                             bqkv2, wpx, wpc, ox, oc, lse_x, lse_c, *,
                             num_heads: int, scale_x: float, scale_c: float,
                             cpe=None, img_w: int = 0,
                             rows_per_split: int = 0):
    """lm_dca_attn_bwd's order of work in PyTorch (used by the tests only):
    LN1 (of the CPE'd x, rounded once, with ``cpe``) rounded to x's dtype,
    qkv1 / qkv2 rounded (k_qkv_wg with each stream's weights), dO = dproj
    Wp rounded (k_rowmm_wg), both directions as _attn_bwd_tiles (P from
    the log-sum-exp, dS and P rounded before their products, fp32 sums:
    k_dca_bwd_tc, whose sums over the image rows meet in a fixed order in
    fp32 before one rounding), dqkv1 / dqkv2 rounded, dx = dt1x + LN1'^T
    (dqkv1 Wqkv1') and dc likewise from fp32 sums (with ``cpe`` kept in
    fp32 for the CPE's backward), and each stream's weight gradients over
    its own row ranges of ``rows_per_split`` rows (on CUDA tensors by
    default each stream's k_wgrad_tc split on their device; required on the
    CPU), rounded once. In fp32 nothing rounds."""
    dt = x.dtype
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    shapes = [(3 * ch, ch), (ch, ch)]
    rps = [rows_per_split or _tiles_rows(x, r, 0, shapes)
           for r in (b * n, b * m)]
    xc = x if cpe is None else cpe_rows_plain(x, *cpe, img_w)
    ts, grads, dws = (xc, c), [], []
    qkv = [(_norm(t).to(dt), w, bias) for t, w, bias in
           ((xc, wqkv1, bqkv1), (c, wqkv2, bqkv2))]
    q1, k1, v1, q2, k2, v2 = [
        u for a, w, bias in qkv
        for u in (a.float() @ w.float().t() + bias.float()).to(dt).chunk(
            3, -1)]
    dps = (_dproj(dp[0], dt1x), _dproj(dp[2], dt1c))
    d_o = [(d.float() @ w.float()).to(dt) for d, w in zip(dps, (wpx, wpc))]
    dq1, dk2, dv2 = _attn_bwd_tiles(q1, k2, v2, ox, d_o[0], lse_x, h,
                                    scale_x, dt)
    dq2, dk1, dv1 = _attn_bwd_tiles(q2, k1, v1, oc, d_o[1], lse_c, h,
                                    scale_c, dt)
    dqkvs = [torch.cat(u, -1).to(dt) for u in ((dq1, dk1, dv1),
                                               (dq2, dk2, dv2))]
    for t, dt1, dqkv, (a, w, _), dproj, o, r in zip(
            ts, (dt1x, dt1c), dqkvs, qkv, dps, (ox, oc), rps):
        grads.append(dt1.float() + _ln_bwd(dqkv.float() @ w.float(), t))
        dws += [*_wgrad_ranges([(dqkv.reshape(-1, 3 * ch),
                                 a.reshape(-1, ch))], r),
                *_wgrad_ranges([(dproj.reshape(-1, ch),
                                 o.reshape(-1, ch))], r)]
    dx, dtaps, dbias = ((grads[0].to(dt), None, None) if cpe is None
                        else _cpe_bwd_plain(x, grads[0], cpe, img_w))
    like = (wqkv1, bqkv1, wpx, wpx, wqkv2, bqkv2, wpc, wpc)
    dws = [g.to(p.dtype) for g, p in zip(dws, like)]
    return (dx, grads[1].to(dt), dws[0], dws[1], dws[4], dws[5], dws[2],
            dws[3], dws[6], dws[7], dtaps, dbias)


def c_train_fwd_plain(x, c, params, dp, *, num_heads: int, cpe=None,
                      img_w: int = 0):
    """C-block forward (the TPU's _c_train_fwd_kernel): (c_out, t1c, o,
    lse); lse is (B, H, M) fp32, the rest in x's dtype. With ``cpe`` x is
    the pre-CPE tokens, whose CPE feeds k and v."""
    wq, bq, wkv, bkv, wp, bp, w1, b1, w2, b2 = params
    dt = x.dtype
    xc = x if cpe is None else cpe_rows_plain(x, *cpe, img_w)
    q = F.linear(_norm(c).to(dt), wq, bq)
    k, v = F.linear(_norm(xc).to(dt), wkv, bkv).chunk(2, -1)
    o, lse = _attn_fwd(q, k, v, num_heads,
                       (x.shape[-1] // num_heads) ** -0.5)
    o = o.to(dt)
    co, t1c = _tail(c, o, wp, bp, dp[2], dp[3], w1, b1, w2, b2)
    return co, t1c, o, lse


def c_attn_bwd_plain(x, c, dt1c, dp, wq, bq, wkv, bkv, wp, o, lse, *,
                     num_heads: int, cpe=None, img_w: int = 0):
    """C-block attention backward (the TPU's _c_attn_bwd_kernel): returns
    (dxt, dc, dWq, dbq, dWkv, dbkv, dWp, dbp, dtaps, dbias). dxt is the
    gradient through k / v alone (with ``cpe``, through the CPE too): x's
    identity path past the block is autograd's. dtaps and dbias are None
    without a CPE."""
    dt = x.dtype
    xc = x if cpe is None else cpe_rows_plain(x, *cpe, img_w)
    dpc = _dproj(dp[2], dt1c)
    ax, ac = _norm(xc).to(dt), _norm(c).to(dt)
    q = F.linear(ac, wq, bq)
    k, v = F.linear(ax, wkv, bkv).chunk(2, -1)
    dq, dk, dv = _attn_bwd(q, k, v, o, dpc.float() @ wp.float(), lse,
                           num_heads, (x.shape[-1] // num_heads) ** -0.5)
    dq, dkv = dq.to(dt), torch.cat([dk, dv], -1).to(dt)
    dxt = _ln_bwd(dkv.float() @ wkv.float(), xc)
    dc = dt1c.float() + _ln_bwd(dq.float() @ wq.float(), c)
    dxt, dtaps, dbias = ((dxt.to(dt), None, None) if cpe is None
                         else _cpe_bwd_plain(x, dxt, cpe, img_w))
    return (dxt, dc.to(dt), _wgrad(dq, ac).to(wq.dtype),
            _colsum(dq).to(bq.dtype), _wgrad(dkv, ax).to(wkv.dtype),
            _colsum(dkv).to(bkv.dtype), _wgrad(dpc, o).to(wp.dtype),
            _colsum(dpc).to(wp.dtype), dtaps, dbias)



def c_train_fwd_tiles_plain(x, c, params, dp, *, num_heads: int, cpe=None,
                            img_w: int = 0):
    """lm_c_train_fwd's order of work in PyTorch (used by the tests only):
    with ``cpe`` the CPE'd x rounded once (k_qkv_wg stages it); kv =
    LN1(x) Wkv'^T + bkv' and q = LN1(c) Wq'^T + bq' with LN1 and the fp32
    product rounded to x's dtype (k_qkv_wg, two widths); the meta queries
    over the image keys as ``attn/dca.py::dca_c_tiles_plain`` with each
    meta row's log-sum-exp (k_dca_tc's per-warp partials merged per tile,
    the tiles merged in k_dca_merge's fixed order, then m scale + ln l);
    the tail on the meta rows as k_tail_wg's training instance
    (fused_block._tail_tiles with s1c / s2c). Returns what
    c_train_fwd_plain returns. In fp32 nothing rounds."""
    from lemevit_tpu_torch.attn.dca import dca_c_tiles_plain
    wq, bq, wkv, bkv, wp, bp, w1, b1, w2, b2 = params
    dt = x.dtype
    xc = fb._cpe_rounded(x, cpe, img_w)
    k, v = fb._qkv_tiles(xc, None, None, wkv, bkv, dt).chunk(2, -1)
    q = fb._qkv_tiles(c, None, None, wq, bq, dt)
    o, lse = dca_c_tiles_plain(q, k, v, scale_c=fb.HEAD_DIM ** -0.5,
                               num_heads=num_heads)
    co, t1c = fb._tail_tiles(c, o, wp, bp, None, None, w1, b1, w2, b2, dt,
                             dp[2], dp[3])
    return co, t1c, o, lse


def c_attn_bwd_tiles_plain(x, c, dt1c, dp, wq, bq, wkv, bkv, wp, o, lse, *,
                           num_heads: int, cpe=None, img_w: int = 0,
                           rows_per_split: int = 0):
    """lm_c_attn_bwd's order of work in PyTorch (used by the tests only):
    LN1 (of the CPE'd x, rounded once, with ``cpe``) rounded to x's dtype,
    kv and q rounded (k_qkv_wg, two widths), dO = dproj Wp rounded
    (k_rowmm_wg), the c direction's backward as _attn_bwd_tiles (P from the
    log-sum-exp, dS and P rounded before their products, fp32 sums:
    k_dca_bwd_tc, whose sums of dq over the image rows meet per range and
    then in range order in fp32 before one rounding), dkv and dq rounded,
    dxt = LN1'^T (dkv Wkv') with no residual and dc = dt1c + LN1'^T (dq
    Wq') from fp32 sums (with ``cpe`` dxt kept in fp32 for the CPE's
    backward), and each stream's weight gradients over its own row ranges
    of ``rows_per_split`` rows (on CUDA tensors by default each stream's
    k_wgrad_tc split on their device; required on the CPU), dbp among
    them, rounded once. In fp32 nothing rounds."""
    dt = x.dtype
    b, n, ch = x.shape
    m = c.shape[1]
    rps = [rows_per_split or _tiles_rows(x, r, 0, shapes) for r, shapes in
           ((b * n, [(2 * ch, ch)]), (b * m, [(ch, ch), (ch, ch)]))]
    xc = x if cpe is None else cpe_rows_plain(x, *cpe, img_w)
    ax, ac = _norm(xc).to(dt), _norm(c).to(dt)
    k, v = (ax.float() @ wkv.float().t() + bkv.float()).to(dt).chunk(2, -1)
    q = (ac.float() @ wq.float().t() + bq.float()).to(dt)
    dproj = _dproj(dp[2], dt1c)
    d_o = (dproj.float() @ wp.float()).to(dt)
    dq, dk, dv = _attn_bwd_tiles(q, k, v, o, d_o, lse, num_heads,
                                 fb.HEAD_DIM ** -0.5, dt)
    dq, dkv = dq.to(dt), torch.cat([dk, dv], -1).to(dt)
    dxt = _ln_bwd(dkv.float() @ wkv.float(), xc)
    dc = dt1c.float() + _ln_bwd(dq.float() @ wq.float(), c)
    dwkv, dbkv = _wgrad_ranges([(dkv.reshape(-1, 2 * ch),
                                 ax.reshape(-1, ch))], rps[0])
    dwq, dbq = _wgrad_ranges([(dq.reshape(-1, ch), ac.reshape(-1, ch))],
                             rps[1])
    dwp, dbp = _wgrad_ranges([(dproj.reshape(-1, ch), o.reshape(-1, ch))],
                             rps[1])
    dxt, dtaps, dbias = ((dxt.to(dt), None, None) if cpe is None
                         else _cpe_bwd_plain(x, dxt, cpe, img_w))
    return (dxt, dc.to(dt), dwq.to(wq.dtype), dbq.to(bq.dtype),
            dwkv.to(wkv.dtype), dbkv.to(bkv.dtype), dwp.to(wp.dtype),
            dbp.to(wp.dtype), dtaps, dbias)

def cpe_rows_plain(x, taps, bias, img_w: int, dtype=None) -> torch.Tensor:
    """The 3x3 CPE of (B, N, C) tokens from images img_w wide
    (``fused_block.cpe_plain``) computed in fp32 and rounded once to
    ``dtype`` (x's by default). bias may be None. With the taps flipped
    (``taps.flip(0)``) and no bias, the CPE's transpose. Differentiable."""
    return fb.cpe_plain(x.float(), taps.float(),
                        None if bias is None else bias.float(),
                        img_w).to(dtype or x.dtype)


def cpe_tap_grads_plain(x, du, img_w: int):
    """The CPE's parameter gradients (dtaps (9, C), dbias (C,)) in fp32 from
    x, its input, and du, the gradient at its output (both (B, N, C)): the
    autograd of ``fused_block.cpe_plain``, which is linear in them."""
    ch = x.shape[-1]
    taps = torch.zeros(9, ch, device=x.device, requires_grad=True)
    bias = torch.zeros(ch, device=x.device, requires_grad=True)
    with torch.enable_grad():
        y = fb.cpe_plain(x.detach().float(), taps, bias, img_w)
        return torch.autograd.grad(y, (taps, bias), du.float())


def _cpe_bwd_plain(x, du, cpe, img_w):
    """The CPE's backward from the fp32 gradient du at its output: (dx =
    CPE^T du in x's dtype, dtaps, dbias in the CPE's dtype)."""
    taps, bias = cpe
    dtaps, dbias = cpe_tap_grads_plain(x, du, img_w)
    dx = cpe_rows_plain(du, taps.flip(0), None, img_w, x.dtype)
    return dx, dtaps.to(taps.dtype), dbias.to(bias.dtype)


def _ln(t):
    return F.layer_norm(t, (t.shape[-1],), eps=LN_EPS)


def _tail_autograd(t, o, wp, bp, s1, s2, w1, b1, w2, b2):
    """One stream's tail under autograd: t1 = t + s1 proj(o), out = t1 +
    s2 MLP(norm(t1))."""
    t1 = t + _col(s1, t).to(t.dtype) * F.linear(o, wp, bp)
    mlp = F.linear(F.gelu(F.linear(_ln(t1), w1, b1)), w2, b2)
    return t1 + _col(s2, t).to(t.dtype) * mlp


def s_block_train_plain(x, c, params, dp, *, num_heads: int, cpe=None,
                        img_w: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The S block composed in PyTorch under autograd, with the LN-folded
    params, branch scales and CPE of s_block_train."""
    wqkv, bqkv, wp, bp, w1, b1, w2, b2 = params
    if cpe is not None:
        x = cpe_rows_plain(x, *cpe, img_w)

    def branch(t, s1, s2):
        b, n, ch = t.shape
        h = num_heads
        qkv = F.linear(_ln(t), wqkv, bqkv).view(b, n, 3, h, ch // h)
        o = sdpa_bnhd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return _tail_autograd(t, o.reshape(b, n, ch), wp, bp, s1, s2, w1, b1,
                              w2, b2)

    return branch(x, dp[0], dp[1]), branch(c, dp[2], dp[3])


def dca_block_train_plain(x, c, params, dp, *, num_heads: int,
                          scale_x: float, scale_c: float, cpe=None,
                          img_w: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The D block composed in PyTorch under autograd, with the LN-folded
    params, branch scales and CPE of dca_block_train."""
    wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc, w1, b1, w2, b2 = params
    if cpe is not None:
        x = cpe_rows_plain(x, *cpe, img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    qkv1 = F.linear(_ln(x), wqkv1, bqkv1).view(b, n, 3, h, ch // h)
    qkv2 = F.linear(_ln(c), wqkv2, bqkv2).view(b, m, 3, h, ch // h)
    ox = sdpa_bnhd(qkv1[:, :, 0], qkv2[:, :, 1], qkv2[:, :, 2],
                   scale=scale_x).reshape(b, n, ch)
    oc = sdpa_bnhd(qkv2[:, :, 0], qkv1[:, :, 1], qkv1[:, :, 2],
                   scale=scale_c).reshape(b, m, ch)
    return (_tail_autograd(x, ox, wpx, bpx, dp[0], dp[1], w1, b1, w2, b2),
            _tail_autograd(c, oc, wpc, bpc, dp[2], dp[3], w1, b1, w2, b2))


def c_block_train_plain(x, c, params, dp, *, num_heads: int, cpe=None,
                        img_w: int = 0) -> torch.Tensor:
    """The C block composed in PyTorch under autograd, with the LN-folded
    params, branch scales and CPE (on the k / v side) of c_block_train.
    Returns the new c."""
    wq, bq, wkv, bkv, wp, bp, w1, b1, w2, b2 = params
    if cpe is not None:
        x = cpe_rows_plain(x, *cpe, img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    q = F.linear(_ln(c), wq, bq).view(b, m, h, ch // h)
    kv = F.linear(_ln(x), wkv, bkv).view(b, n, 2, h, ch // h)
    o = sdpa_bnhd(q, kv[:, :, 0], kv[:, :, 1]).reshape(b, m, ch)
    return _tail_autograd(c, o, wp, bp, dp[2], dp[3], w1, b1, w2, b2)


# ---------------------------------------------------------------- CUDA


def _param_shapes(kind: str, ch: int, hidden: int):
    """The LN-folded parameter shapes of an "s", "dca" or "c" block."""
    attn = {"s": [(3 * ch, ch), (3 * ch,), (ch, ch), (ch,)],
            "dca": [(3 * ch, ch), (3 * ch,), (3 * ch, ch), (3 * ch,),
                    (ch, ch), (ch,), (ch, ch), (ch,)],
            "c": [(ch, ch), (ch,), (2 * ch, ch), (2 * ch,), (ch, ch),
                  (ch,)]}[kind]
    return attn + [(hidden, ch), (hidden,), (ch, hidden), (ch,)]


def _check(name, kind, x, c, params: Sequence[torch.Tensor], dp,
           num_heads: int, cpe=None, img_w: int = 0):
    b, n, ch = x.shape
    hidden = params[-4].shape[0]
    _check_train_dim(name, ch)
    fb._check(name, x, c, params, num_heads, hidden, cpe, img_w)
    fb._check_shapes(name, params, _param_shapes(kind, ch, hidden))
    if (dp.dtype != torch.float32 or tuple(dp.shape) != (4, b)
            or dp.device != x.device or not dp.is_contiguous()):
        raise ValueError(f"{name}: dp must be a contiguous float32 (4, {b}) "
                         f"tensor on {x.device}, got {dp.dtype} "
                         f"{tuple(dp.shape)} on {dp.device}")


def _check_tensors(name, like, tensors) -> None:
    for i, t in enumerate(tensors):
        if not t.is_contiguous() or t.dtype != like.dtype or not t.is_cuda:
            raise ValueError(f"{name}: tensor {i} must be a contiguous "
                             f"CUDA {like.dtype} tensor")


def _wgrad_tc_split(rows0: int, rows1: int, shapes, sms: int
                    ) -> Tuple[int, int]:
    """(rows_per_split, splits) of k_wgrad_tc (128 x 128 tiles, all (O, I)
    products of a launch): enough row ranges that the products together
    launch about two blocks on each of the device's ``sms``
    multiprocessors, at least 128 rows, a multiple of 64, per range; each
    stream's rows split on their own."""
    tiles = sum(-(-o // WGRAD_TC_TILE) * -(-i // WGRAD_TC_TILE)
                for o, i in shapes)
    want = max(1, -(-2 * sms // tiles))
    rps = max(128, -(-(rows0 + rows1) // want))
    rps = -(-rps // 64) * 64
    return rps, -(-rows0 // rps) + -(-rows1 // rps)


def train_takes(attn_type: str, ch: int, num_heads: int, hidden: int,
                m: int, dtype) -> bool:
    """Whether a block's training kernels take its shapes and dtype: the
    inference kernels' limits (``fused_block.block_takes``: head_dim 32,
    the MLP width a multiple of 32, fp32 or bf16, at most ``MAX_META``
    meta tokens in a D block, whose attention backward stages them all)
    and C <= MAX_TRAIN_DIM. Decided from shapes alone, without CUDA."""
    return (ch <= MAX_TRAIN_DIM
            and fb.block_takes(attn_type, ch, num_heads, hidden, m, dtype))


def _check_train_dim(name: str, ch: int) -> None:
    """Raise for a width past the training row kernels' MAX_TRAIN_DIM (every
    block's backward runs mlp_bwd, so its forward refuses it too)."""
    if ch > MAX_TRAIN_DIM:
        raise ValueError(f"{name}: C={ch} exceeds the training kernels' "
                         f"{MAX_TRAIN_DIM} (fused_train.MAX_TRAIN_DIM)")


def _cpe_split(rows: int, sms: int) -> Tuple[int, int]:
    """(rows_per_split, splits) of k_cpe_tap_grads: one block per row range
    (all channels), about four blocks on each of the device's ``sms``
    multiprocessors, at least CPE_GRAD_ROWS rows (a multiple of 8) per
    block."""
    rps = max(CPE_GRAD_ROWS, -(-rows // (4 * sms)))
    rps = -(-rps // 8) * 8
    return rps, -(-rows // rps)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ws(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def _cpe_fwd_args(x, cpe):
    """A forward's CPE pointers: taps, bias and the CPE'd-x workspace, or
    three nulls."""
    if cpe is None:
        return [None] * 3
    return [*cpe, torch.empty_like(x)]


def _cpe_bwd_args(name, x, cpe, img_w):
    """An attention backward's CPE pointers (taps, bias; workspaces: the
    CPE'd x, du in fp32, the tap-gradient partials; outputs dtaps, dbias)
    and k_cpe_tap_grads' rows per block; seven nulls and 0 without a CPE."""
    if cpe is None:
        return [None] * 7, 0
    fb._check_cpe(name, x, cpe, img_w)
    _check_tensors(name, x, cpe)
    if any(t.data_ptr() % 16 for t in cpe):
        raise ValueError(f"{name}: CPE taps and bias must be 16-byte "
                         "aligned")
    b, n, ch = x.shape
    rps, splits = _cpe_split(b * n, _sms(x.device))
    f32 = torch.float32
    return [*cpe, torch.empty_like(x), _ws((b * n, ch), x, f32),
            _ws((splits * 10 * ch,), x, f32), torch.empty_like(cpe[0]),
            torch.empty_like(cpe[1])], rps


def _ln_identity(x):
    """The ones / zeros a training kernel takes for LN1's and LN2's affine
    (the weights come folded), made once per width, dtype and device."""
    return _identity(x.shape[-1], x.dtype, x.device)


@functools.lru_cache(maxsize=None)
def _identity(ch, dtype, device):
    return (torch.ones(ch, dtype=dtype, device=device),
            torch.zeros(ch, dtype=dtype, device=device))


def s_train_fwd(x, c, params, dp, *, num_heads: int, cpe=None,
                img_w: int = 0):
    """The S forward phase; see s_train_fwd_plain."""
    if not x.is_cuda:
        return s_train_fwd_plain(x, c, params, dp, num_heads=num_heads,
                                 cpe=cpe, img_w=img_w)
    _check("s_train_fwd", "s", x, c, params, dp, num_heads, cpe, img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    hidden = params[4].shape[0]
    f32 = torch.float32
    outs = [torch.empty_like(x), torch.empty_like(c), torch.empty_like(x),
            torch.empty_like(c), _ws((b, n, ch), x), _ws((b, m, ch), x),
            _ws((b, num_heads, n), x, f32), _ws((b, num_heads, m), x, f32)]
    work = [_ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x)]
    fb._launch("s_train_fwd", x, [x, c, *_ln_identity(x), *params, dp,
                                  *outs, *work, *_cpe_fwd_args(x, cpe)],
               b, n, m, ch, num_heads, hidden, img_w, fb.HEAD_DIM ** -0.5,
               LN_EPS, counts=LAUNCHES)
    return tuple(outs)


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (the
    tensor-core kernels read rows by TMA and 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mlp_bwd(t1x, t1c, dxo, dco, dp, w1, b1, w2):
    """The MLP-backward phase; see mlp_bwd_plain (bf16 rounding:
    mlp_bwd_tiles_plain). The image stream (t1x, dxo) may hold no
    tokens."""
    if not t1x.is_cuda:
        return mlp_bwd_plain(t1x, t1c, dxo, dco, dp, w1, b1, w2)
    b, n, ch = t1x.shape
    m = t1c.shape[1]
    hidden = w1.shape[0]
    _check_train_dim("mlp_bwd", ch)
    dzx = _dproj(dp[1], dxo)
    dzc = _dproj(dp[3], dco)
    rps, splits = _wgrad_tc_split(b * n, b * m,
                                  [(hidden, ch), (ch, hidden)],
                                  _sms(t1x.device))
    f32 = torch.float32
    outs = [torch.empty_like(t1x), torch.empty_like(t1c),
            torch.empty_like(w1), torch.empty_like(b1), torch.empty_like(w2)]
    db2 = w2.new_empty(ch)
    work = [_ws((b * n, ch), t1x), _ws((b * m, ch), t1x),
            _ws((b * n, hidden), t1x), _ws((b * m, hidden), t1x),
            _ws((b * n, hidden), t1x), _ws((b * m, hidden), t1x),
            _ws((splits * 2 * hidden * ch,), t1x, f32),
            _ws((splits * (hidden + ch),), t1x, f32)]
    tensors = [_aligned(t) for t in (t1x, t1c, dxo, dco, dzx, dzc, w1, b1)]
    tensors += [w2.t().contiguous(), w1.t().contiguous()]
    _check_tensors("mlp_bwd", t1x, tensors)
    fb._launch("mlp_bwd", t1x, [*tensors, *outs, *work, db2], b, n, m, ch,
               hidden, rps, LN_EPS, counts=LAUNCHES)
    return (*outs, db2)


def s_attn_bwd(x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox, oc, lse_x, lse_c,
               *, num_heads: int, cpe=None, img_w: int = 0):
    """The S attention-backward phase; see s_attn_bwd_plain (bf16 rounding:
    s_attn_bwd_tiles_plain)."""
    if not x.is_cuda:
        return s_attn_bwd_plain(x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox,
                                oc, lse_x, lse_c, num_heads=num_heads,
                                cpe=cpe, img_w=img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    _check_train_dim("s_attn_bwd", ch)
    dpx, dpc = _dproj(dp[0], dt1x), _dproj(dp[2], dt1c)
    dbp = wp.new_empty(ch)
    rps, splits = _wgrad_tc_split(b * n, b * m, [(3 * ch, ch), (ch, ch)],
                                  _sms(x.device))
    f32 = torch.float32
    outs = [torch.empty_like(x), torch.empty_like(c), torch.empty_like(wqkv),
            torch.empty_like(bqkv), torch.empty_like(wp)]
    work = [_ws((b * n, ch), x), _ws((b * m, ch), x),
            _ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x),
            _ws((b * n, ch), x), _ws((b * m, ch), x),
            _ws((b * h * n,), x, f32), _ws((b * h * m,), x, f32),
            _ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x),
            _ws((splits * 4 * ch * ch,), x, f32),
            _ws((splits * 4 * ch,), x, f32)]
    tensors = [_aligned(t) for t in (x, c, dt1x, dt1c, dpx, dpc, wqkv, bqkv)]
    tensors += [wqkv.t().contiguous(), wp.t().contiguous(), _aligned(ox),
                _aligned(oc)]
    _check_tensors("s_attn_bwd", x, tensors)
    cpe_args, cpe_rps = _cpe_bwd_args("s_attn_bwd", x, cpe, img_w)
    fb._launch("s_attn_bwd", x, [*tensors, lse_x, lse_c, *outs, *work,
                                 *cpe_args, *_ln_identity(x), dbp],
               b, n, m, ch, h, rps, img_w, cpe_rps, fb.HEAD_DIM ** -0.5,
               LN_EPS, counts=LAUNCHES)
    return (*outs, dbp, *cpe_args[-2:])


def dca_train_fwd(x, c, params, dp, *, num_heads: int, scale_x: float,
                  scale_c: float, cpe=None, img_w: int = 0):
    """The D forward phase; see dca_train_fwd_plain."""
    if not x.is_cuda:
        return dca_train_fwd_plain(x, c, params, dp, num_heads=num_heads,
                                   scale_x=scale_x, scale_c=scale_c,
                                   cpe=cpe, img_w=img_w)
    _check("dca_train_fwd", "dca", x, c, params, dp, num_heads, cpe, img_w)
    fb.check_meta("dca_train_fwd", c.shape[1], x.dtype)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    hidden = params[8].shape[0]
    f32 = torch.float32
    outs = [torch.empty_like(x), torch.empty_like(c), torch.empty_like(x),
            torch.empty_like(c), _ws((b, n, ch), x), _ws((b, m, ch), x),
            _ws((b, h, n), x, f32), _ws((b, h, m), x, f32)]
    work = [_ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x),
            *fb.dca_partials(b, h, m, n, x)]
    fb._launch("dca_train_fwd", x, [x, c, *_ln_identity(x), *params, dp,
                                    *outs, *work, *_cpe_fwd_args(x, cpe)],
               b, n, m, ch, h, hidden, img_w, scale_x, scale_c, LN_EPS,
               counts=LAUNCHES)
    return tuple(outs)


def _dca_bwd_chunks(n: int, bh: int, m: int, dtype, sms: int
                    ) -> Tuple[int, int]:
    """(chunks, ranges) of k_dca_bwd_tc for ``bh`` (image, head) pairs of
    n image rows: ranges of ``chunks`` DCA_BWD_ROWS-row chunks, enough of
    them that the CTAs number about four per multiprocessor; one chunk a
    range past one meta tile (m > 16), whose sums then leave per chunk."""
    total = -(-n // DCA_BWD_ROWS[dtype])
    chunks = 1 if m > 16 else max(1, -(-total // -(-4 * sms // bh)))
    return chunks, -(-total // chunks)


def dca_attn_bwd(x, c, dt1x, dt1c, dp, wqkv1, bqkv1, wqkv2, bqkv2, wpx, wpc,
                 ox, oc, lse_x, lse_c, *, num_heads: int, scale_x: float,
                 scale_c: float, cpe=None, img_w: int = 0):
    """The D attention-backward phase; see dca_attn_bwd_plain (bf16
    rounding: dca_attn_bwd_tiles_plain)."""
    if not x.is_cuda:
        return dca_attn_bwd_plain(
            x, c, dt1x, dt1c, dp, wqkv1, bqkv1, wqkv2, bqkv2, wpx, wpc, ox,
            oc, lse_x, lse_c, num_heads=num_heads, scale_x=scale_x,
            scale_c=scale_c, cpe=cpe, img_w=img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    _check_train_dim("dca_attn_bwd", ch)
    fb.check_meta("dca_attn_bwd", m, x.dtype)
    dpx, dpc = _dproj(dp[0], dt1x), _dproj(dp[2], dt1c)
    shapes = [(3 * ch, ch), (ch, ch)]
    sms = _sms(x.device)
    rps_x, sx = _wgrad_tc_split(b * n, 0, shapes, sms)
    rps_c, sc = _wgrad_tc_split(b * m, 0, shapes, sms)
    splits = max(sx, sc)
    chunks, ranges = _dca_bwd_chunks(n, b * h, m, x.dtype, sms)
    mp = -(-m // 16) * 16
    f32 = torch.float32
    outs = [torch.empty_like(x), torch.empty_like(c),
            torch.empty_like(wqkv1), torch.empty_like(bqkv1),
            torch.empty_like(wqkv2), torch.empty_like(bqkv2),
            torch.empty_like(wpx), wpx.new_empty(ch), torch.empty_like(wpc),
            wpc.new_empty(ch)]
    work = [_ws((b * n, ch), x), _ws((b * m, ch), x),
            _ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x),
            _ws((b * n, ch), x), _ws((b * m, ch), x),
            _ws((b * h * n,), x, f32), _ws((b * h * m,), x, f32),
            _ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x),
            _ws((b * h * ranges * mp * 3 * fb.HEAD_DIM,), x, f32),
            _ws((splits * 4 * ch * ch,), x, f32),
            _ws((splits * 4 * ch,), x, f32)]
    tensors = [_aligned(t) for t in (x, c, dt1x, dt1c, dpx, dpc, wqkv1,
                                     bqkv1, wqkv2, bqkv2)]
    tensors += [wqkv1.t().contiguous(), wqkv2.t().contiguous(),
                wpx.t().contiguous(), wpc.t().contiguous(), _aligned(ox),
                _aligned(oc)]
    _check_tensors("dca_attn_bwd", x, tensors)
    cpe_args, cpe_rps = _cpe_bwd_args("dca_attn_bwd", x, cpe, img_w)
    fb._launch("dca_attn_bwd", x, [*tensors, lse_x, lse_c, *outs, *work,
                                   *cpe_args, *_ln_identity(x)],
               b, n, m, ch, h, rps_x, rps_c, chunks, img_w, cpe_rps,
               scale_x, scale_c, LN_EPS, counts=LAUNCHES)
    return (*outs, *cpe_args[-2:])


def c_train_fwd(x, c, params, dp, *, num_heads: int, cpe=None,
                img_w: int = 0):
    """The C forward phase; see c_train_fwd_plain."""
    if not x.is_cuda:
        return c_train_fwd_plain(x, c, params, dp, num_heads=num_heads,
                                 cpe=cpe, img_w=img_w)
    _check("c_train_fwd", "c", x, c, params, dp, num_heads, cpe, img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    hidden = params[6].shape[0]
    outs = [torch.empty_like(c), torch.empty_like(c), _ws((b, m, ch), x),
            _ws((b, h, m), x, torch.float32)]
    work = [_ws((b * m, ch), x), _ws((b * n, 2 * ch), x),
            *fb.dca_partials(b, h, m, n, x)]
    fb._launch("c_train_fwd", x, [x, c, *_ln_identity(x), *params, dp,
                                  *outs, *work, *fb._cpe_ptrs(cpe)],
               b, n, m, ch, h, hidden, img_w, fb.HEAD_DIM ** -0.5, LN_EPS,
               counts=LAUNCHES)
    return tuple(outs)


def c_attn_bwd(x, c, dt1c, dp, wq, bq, wkv, bkv, wp, o, lse, *,
               num_heads: int, cpe=None, img_w: int = 0):
    """The C attention-backward phase; see c_attn_bwd_plain (bf16 rounding:
    c_attn_bwd_tiles_plain)."""
    if not x.is_cuda:
        return c_attn_bwd_plain(x, c, dt1c, dp, wq, bq, wkv, bkv, wp, o, lse,
                                num_heads=num_heads, cpe=cpe, img_w=img_w)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    _check_train_dim("c_attn_bwd", ch)
    dpc = _dproj(dp[2], dt1c)
    sms = _sms(x.device)
    rps_x, sx = _wgrad_tc_split(b * n, 0, [(2 * ch, ch)], sms)
    rps_c, sc = _wgrad_tc_split(b * m, 0, [(ch, ch), (ch, ch)], sms)
    splits = max(sx, sc)
    chunks, ranges = _dca_bwd_chunks(n, b * h, m, x.dtype, sms)
    mp = -(-m // 16) * 16
    f32 = torch.float32
    outs = [torch.empty_like(x), torch.empty_like(c), torch.empty_like(wq),
            torch.empty_like(bq), torch.empty_like(wkv),
            torch.empty_like(bkv), torch.empty_like(wp), wp.new_empty(ch)]
    work = [_ws((b * n, ch), x), _ws((b * m, ch), x),
            _ws((b * n, 2 * ch), x), _ws((b * m, ch), x),
            _ws((b * m, ch), x), _ws((b * h * m,), x, f32),
            _ws((b * n, 2 * ch), x), _ws((b * m, ch), x),
            _ws((b * h * ranges * mp * fb.HEAD_DIM,), x, f32),
            _ws((splits * 2 * ch * ch,), x, f32),
            _ws((splits * 2 * ch,), x, f32)]
    tensors = [_aligned(t) for t in (x, c, dt1c, dpc, wq, bq, wkv, bkv)]
    tensors += [wq.t().contiguous(), wkv.t().contiguous(),
                wp.t().contiguous(), _aligned(o)]
    _check_tensors("c_attn_bwd", x, tensors)
    cpe_args, cpe_rps = _cpe_bwd_args("c_attn_bwd", x, cpe, img_w)
    fb._launch("c_attn_bwd", x, [*tensors, lse, *outs, *work, *cpe_args,
                                 *_ln_identity(x)],
               b, n, m, ch, h, rps_x, rps_c, chunks, img_w, cpe_rps,
               fb.HEAD_DIM ** -0.5, LN_EPS, counts=LAUNCHES)
    return (*outs, *cpe_args[-2:])


def _upstream(g, like):
    """An output's incoming gradient as the kernels take it (zeros where
    autograd passes None)."""
    return (torch.zeros_like(like) if g is None
            else g.to(like.dtype).contiguous())


def _cpe_pair(taps, bias):
    return None if taps is None else (taps.contiguous(), bias.contiguous())


class _STrain(torch.autograd.Function):
    """Forward and backward of s_block_train across both token streams."""

    @staticmethod
    def forward(ctx, x, c, dp, num_heads, img_w, taps, bias, *params):
        x, c = x.contiguous(), c.contiguous()
        params = [p.contiguous() for p in params]
        cpe = _cpe_pair(taps, bias)
        xo, co, t1x, t1c, ox, oc, lx, lc = s_train_fwd(
            x, c, params, dp, num_heads=num_heads, cpe=cpe, img_w=img_w)
        ctx.save_for_backward(x, c, dp, t1x, t1c, ox, oc, lx, lc,
                              *(cpe or (None, None)), *params)
        ctx.kw = dict(num_heads=num_heads, img_w=img_w)
        return xo, co

    @staticmethod
    def backward(ctx, dxo, dco):
        x, c, dp, t1x, t1c, ox, oc, lx, lc, taps, bias, *params = (
            ctx.saved_tensors)
        wqkv, bqkv, wp, _, w1, b1, w2, _ = params
        dt1x, dt1c, dw1, db1, dw2, db2 = mlp_bwd(
            t1x, t1c, _upstream(dxo, x), _upstream(dco, c), dp, w1, b1, w2)
        dx, dc, dwqkv, dbqkv, dwp, dbp, dtaps, dbias = s_attn_bwd(
            x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox, oc, lx, lc,
            cpe=_cpe_pair(taps, bias), **ctx.kw)
        return (dx, dc, None, None, None, dtaps, dbias, dwqkv, dbqkv, dwp,
                dbp, dw1, db1, dw2, db2)


class _DcaTrain(torch.autograd.Function):
    """Forward and backward of dca_block_train."""

    @staticmethod
    def forward(ctx, x, c, dp, num_heads, scale_x, scale_c, img_w, taps,
                bias, *params):
        x, c = x.contiguous(), c.contiguous()
        params = [p.contiguous() for p in params]
        cpe = _cpe_pair(taps, bias)
        ctx.kw = dict(num_heads=num_heads, scale_x=scale_x, scale_c=scale_c,
                      img_w=img_w)
        xo, co, t1x, t1c, ox, oc, lx, lc = dca_train_fwd(
            x, c, params, dp, cpe=cpe, **ctx.kw)
        ctx.save_for_backward(x, c, dp, t1x, t1c, ox, oc, lx, lc,
                              *(cpe or (None, None)), *params)
        return xo, co

    @staticmethod
    def backward(ctx, dxo, dco):
        x, c, dp, t1x, t1c, ox, oc, lx, lc, taps, bias, *params = (
            ctx.saved_tensors)
        wqkv1, bqkv1, wqkv2, bqkv2, wpx, _, wpc, _, w1, b1, w2, _ = params
        dt1x, dt1c, dw1, db1, dw2, db2 = mlp_bwd(
            t1x, t1c, _upstream(dxo, x), _upstream(dco, c), dp, w1, b1, w2)
        g = dca_attn_bwd(x, c, dt1x, dt1c, dp, wqkv1, bqkv1, wqkv2, bqkv2,
                         wpx, wpc, ox, oc, lx, lc,
                         cpe=_cpe_pair(taps, bias), **ctx.kw)
        return (g[0], g[1], None, None, None, None, None, *g[-2:],
                *g[2:-2], dw1, db1, dw2, db2)


class _CTrain(torch.autograd.Function):
    """Forward and backward of c_block_train. The MLP backward runs on the
    meta stream alone (mlp_bwd with an empty image stream)."""

    @staticmethod
    def forward(ctx, x, c, dp, num_heads, img_w, taps, bias, *params):
        x, c = x.contiguous(), c.contiguous()
        params = [p.contiguous() for p in params]
        cpe = _cpe_pair(taps, bias)
        co, t1c, o, lse = c_train_fwd(x, c, params, dp, num_heads=num_heads,
                                      cpe=cpe, img_w=img_w)
        ctx.save_for_backward(x, c, dp, t1c, o, lse, *(cpe or (None, None)),
                              *params)
        ctx.kw = dict(num_heads=num_heads, img_w=img_w)
        return co

    @staticmethod
    def backward(ctx, dco):
        x, c, dp, t1c, o, lse, taps, bias, *params = ctx.saved_tensors
        wq, bq, wkv, bkv, wp, _, w1, b1, w2, _ = params
        none = x.new_empty((x.shape[0], 0, x.shape[2]))
        _, dt1c, dw1, db1, dw2, db2 = mlp_bwd(
            none, t1c, none, _upstream(dco, c), dp, w1, b1, w2)
        dxt, dc, dwq, dbq, dwkv, dbkv, dwp, dbp, dtaps, dbias = c_attn_bwd(
            x, c, dt1c, dp, wq, bq, wkv, bkv, wp, o, lse,
            cpe=_cpe_pair(taps, bias), **ctx.kw)
        return (dxt, dc, None, None, None, dtaps, dbias, dwq, dbq, dwkv,
                dbkv, dwp, dbp, dw1, db1, dw2, db2)


def _cpe_in(cpe):
    """(taps, bias) as the Functions take them, None twice without a
    CPE."""
    return (None, None) if cpe is None else tuple(cpe)


def s_block_train(x, c, params, dp, *, num_heads: int, cpe=None,
                  img_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable S block for training; see the module docstring."""
    return _STrain.apply(x, c, dp, num_heads, img_w, *_cpe_in(cpe), *params)


def dca_block_train(x, c, params, dp, *, num_heads: int, scale_x: float,
                    scale_c: float, cpe=None, img_w: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable D (and D2) block for training; see the module
    docstring."""
    return _DcaTrain.apply(x, c, dp, num_heads, float(scale_x),
                           float(scale_c), img_w, *_cpe_in(cpe), *params)


def c_block_train(x, c, params, dp, *, num_heads: int, cpe=None,
                  img_w: int = 0) -> torch.Tensor:
    """Differentiable C block for training: returns the new c; see the
    module docstring."""
    return _CTrain.apply(x, c, dp, num_heads, img_w, *_cpe_in(cpe), *params)
