"""Training kernels of the pre-norm S block: counterpart of
lemevit_tpu/attn/pallas_train.py::s_block_train (the custom VJP ``_s_train``
with ``_s_train_fwd_call``, ``_mlp_bwd_call`` and ``_s_train_bwd_call``).

  s_block_train(x, c, params, dp, *, num_heads) -> (x_out, c_out)

x is (B, N, C) image tokens *after* the conditional position embedding (the
CPE stays outside, a depthwise ``F.conv2d`` under autograd, as the JAX
package's default); c is (B, M, C) meta tokens. ``params`` is the LN-folded
8-tuple (Wqkv', bqkv', Wp, bp, W1', b1', W2, b2) in torch ``nn.Linear``
layout: ``fold_ln`` folds norm1 into qkv and norm2 into fc1 *outside* the
autograd Function, so autograd chains the LayerNorm gamma / beta gradients.
``dp`` is the (4, B) fp32 table of per-image DropPath branch scales
(s1x, s2x, s1c, s2c): keep_mask / keep, applied to the whole branch
including its bias (timm semantics); it gets no gradient.

The Function runs three phases, each a hand-written kernel chain on CUDA
tensors (``csrc/s_train.cu``) and its plain PyTorch version on CPU tensors:
  s_train_fwd  the forward; also returns t1 (the post-attention residual),
               the attention output o and each query's log-sum-exp
  mlp_bwd      (t1, upstream grads) -> dt1, dW1, db1, dW2, db2
  s_attn_bwd   (x, dt1, o, lse) -> dx, dWqkv, dbqkv, dWp, dbp
The weight gradients accumulate in fp32 and are returned in the parameters'
dtype. ``s_block_train_plain`` is the same block composed under autograd:
the reference the phases are tested against.

``LAUNCHES[name]`` counts kernel launches of each phase (one per call on CUDA
tensors; the plain versions do not count).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import sdpa_bnhd

LN_EPS = fb.LN_EPS
LAUNCHES = {"s_train_fwd": 0, "mlp_bwd": 0, "s_attn_bwd": 0}
WGRAD_TILE = 64         # k_wgrad's output tile edge


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


def s_train_fwd_plain(x, c, params, dp, *, num_heads: int):
    """Forward of both streams: (x_out, c_out, t1x, t1c, o_x, o_c, lse_x,
    lse_c); lse is (B, H, n) fp32, the rest in x's dtype."""
    wqkv, bqkv, wp, bp, w1, b1, w2, b2 = params
    dt = x.dtype

    def branch(t, s1, s2):
        b, n, ch = t.shape
        h = num_heads
        d = ch // h
        qkv = F.linear(_norm(t).to(dt), wqkv, bqkv).view(b, n, 3, h, d)
        q, k, v = (qkv[:, :, i].float() for i in range(3))
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        o = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n, ch).to(dt)
        t1 = t.float() + _col(s1, t) * F.linear(o, wp, bp).float()
        g = F.gelu(F.linear(_norm(t1).to(dt), w1, b1).float()).to(dt)
        out = t1 + _col(s2, t) * F.linear(g, w2, b2).float()
        return out.to(dt), t1.to(dt), o, lse

    xo, t1x, ox, lx = branch(x, dp[0], dp[1])
    co, t1c, oc, lc = branch(c, dp[2], dp[3])
    return xo, co, t1x, t1c, ox, oc, lx, lc


def mlp_bwd_plain(t1x, t1c, dxo, dco, dp, w1, b1, w2):
    """MLP backward of both streams (the TPU's _mlp_bwd_call): returns
    (dt1x, dt1c, dW1, db1, dW2, db2), weight gradients summed over both
    streams in fp32 and returned in the weights' dtype."""
    dt = t1x.dtype
    w1f, w2f = w1.float(), w2.float()
    acc = [0.0, 0.0, 0.0, 0.0]
    dt1s = []
    for t1, dout, s2 in ((t1x, dxo, dp[1]), (t1c, dco, dp[3])):
        ch = t1.shape[-1]
        dz = (_col(s2, dout) * dout.float()).to(dt).reshape(-1, ch)
        t1f = t1.reshape(-1, ch)
        mm = _norm(t1f).to(dt)
        y = mm.float() @ w1f.t() + b1.float()
        dy = ((dz.float() @ w2f) * _gelu_grad(y)).to(dt)
        gg = F.gelu(y).to(dt)
        dmm = dy.float() @ w1f
        dt1 = dout.reshape(-1, ch).float() + _ln_bwd(dmm, t1f)
        dt1s.append(dt1.to(dt).reshape(t1.shape))
        for i, v in enumerate((dy.float().t() @ mm.float(),
                               dy.float().sum(0),
                               dz.float().t() @ gg.float(),
                               dz.float().sum(0))):
            acc[i] = acc[i] + v
    return (dt1s[0], dt1s[1], acc[0].to(w1.dtype), acc[1].to(b1.dtype),
            acc[2].to(w2.dtype), acc[3].to(w2.dtype))


def s_attn_bwd_plain(x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox, oc, lse_x,
                     lse_c, *, num_heads: int):
    """Attention backward of both streams (the TPU's _s_attn_bwd_kernel):
    returns (dx, dc, dWqkv, dbqkv, dWp, dbp). LN1 and qkv are recomputed,
    P is rebuilt from the forward's log-sum-exp."""
    dt = x.dtype
    acc = [0.0, 0.0, 0.0, 0.0]
    grads = []
    for t, dt1, s1, o, lse in ((x, dt1x, dp[0], ox, lse_x),
                               (c, dt1c, dp[2], oc, lse_c)):
        b, n, ch = t.shape
        h = num_heads
        d = ch // h
        scale = d ** -0.5
        dproj = (_col(s1, dt1) * dt1.float()).to(dt)
        a = _norm(t).to(dt)
        qkv = F.linear(a, wqkv, bqkv).view(b, n, 3, h, d)
        q, k, v = (qkv[:, :, i].float() for i in range(3))
        d_o = (dproj.float() @ wp.float()).view(b, n, h, d)
        p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
                      - lse[..., None])
        rowdot = (d_o * o.float().view(b, n, h, d)).sum(-1).permute(0, 2, 1)
        dpr = torch.einsum("bnhd,bmhd->bhnm", d_o, v)
        ds = p * (dpr - rowdot[..., None])
        dq = torch.einsum("bhnm,bmhd->bnhd", ds, k) * scale
        dk = torch.einsum("bhnm,bnhd->bmhd", ds, q) * scale
        dv = torch.einsum("bhnm,bnhd->bmhd", p, d_o)
        dqkv = torch.stack([dq, dk, dv], dim=2).reshape(b * n, 3 * ch).to(dt)
        da = (dqkv.float() @ wqkv.float()).view(b, n, ch)
        grads.append((dt1.float() + _ln_bwd(da, t)).to(dt))
        for i, val in enumerate((dqkv.float().t() @ a.reshape(-1, ch).float(),
                                 dqkv.float().sum(0),
                                 dproj.reshape(-1, ch).float().t()
                                 @ o.reshape(-1, ch).float(),
                                 dproj.float().sum((0, 1)))):
            acc[i] = acc[i] + val
    return (grads[0], grads[1], acc[0].to(wqkv.dtype), acc[1].to(bqkv.dtype),
            acc[2].to(wp.dtype), acc[3].to(wp.dtype))


def s_block_train_plain(x, c, params, dp, *, num_heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The S block composed in PyTorch under autograd, with the LN-folded
    params and branch scales of s_block_train."""
    wqkv, bqkv, wp, bp, w1, b1, w2, b2 = params

    def ln(t):
        return F.layer_norm(t, (t.shape[-1],), eps=LN_EPS)

    def branch(t, s1, s2):
        b, n, ch = t.shape
        h = num_heads
        qkv = F.linear(ln(t), wqkv, bqkv).view(b, n, 3, h, ch // h)
        o = sdpa_bnhd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        t1 = t + _col(s1, t).to(t.dtype) * F.linear(o.reshape(b, n, ch), wp,
                                                    bp)
        mlp = F.linear(F.gelu(F.linear(ln(t1), w1, b1)), w2, b2)
        return t1 + _col(s2, t).to(t.dtype) * mlp

    return branch(x, dp[0], dp[1]), branch(c, dp[2], dp[3])


# ---------------------------------------------------------------- CUDA


def _check(name, x, c, params: Sequence[torch.Tensor], dp, num_heads: int):
    b, n, ch = x.shape
    hidden = params[4].shape[0]
    fb._check(name, x, c, params, num_heads, hidden)
    fb._check_shapes(name, params, [
        (3 * ch, ch), (3 * ch,), (ch, ch), (ch,), (hidden, ch), (hidden,),
        (ch, hidden), (ch,)])
    if (dp.dtype != torch.float32 or tuple(dp.shape) != (4, b)
            or dp.device != x.device or not dp.is_contiguous()):
        raise ValueError(f"{name}: dp must be a contiguous float32 (4, {b}) "
                         f"tensor on {x.device}, got {dp.dtype} "
                         f"{tuple(dp.shape)} on {dp.device}")


def _wgrad_split(rows0: int, rows1: int, shapes, sms: int
                 ) -> Tuple[int, int]:
    """(rows_per_split, splits) of k_wgrad for the (O, I) products of one
    call: enough row ranges that the smallest product launches about four
    blocks on each of the device's ``sms`` multiprocessors."""
    tiles = min(-(-o // WGRAD_TILE) * -(-i // WGRAD_TILE) for o, i in shapes)
    want = max(1, -(-4 * sms // tiles))
    rps = max(128, -(-(rows0 + rows1) // want))
    rps = -(-rps // 32) * 32
    return rps, -(-rows0 // rps) + -(-rows1 // rps)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ws(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def _fwd_cuda(x, c, params, dp, *, num_heads: int):
    _check("s_train_fwd", x, c, params, dp, num_heads)
    b, n, ch = x.shape
    m = c.shape[1]
    hidden = params[4].shape[0]
    f32 = torch.float32
    ones = torch.ones(ch, dtype=x.dtype, device=x.device)
    zeros = torch.zeros(ch, dtype=x.dtype, device=x.device)
    outs = [torch.empty_like(x), torch.empty_like(c), torch.empty_like(x),
            torch.empty_like(c), _ws((b, n, ch), x), _ws((b, m, ch), x),
            _ws((b, num_heads, n), x, f32), _ws((b, num_heads, m), x, f32)]
    work = [_ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x)]
    fb._launch("s_train_fwd", x, [x, c, ones, zeros, *params, dp, *outs,
                                  *work],
               b, n, m, ch, num_heads, hidden, fb.HEAD_DIM ** -0.5, LN_EPS,
               counts=LAUNCHES)
    return tuple(outs)


def s_train_fwd(x, c, params, dp, *, num_heads: int):
    """The forward phase; see the module docstring."""
    if not x.is_cuda:
        return s_train_fwd_plain(x, c, params, dp, num_heads=num_heads)
    return _fwd_cuda(x, c, params, dp, num_heads=num_heads)


def mlp_bwd(t1x, t1c, dxo, dco, dp, w1, b1, w2):
    """The MLP-backward phase; see mlp_bwd_plain."""
    if not t1x.is_cuda:
        return mlp_bwd_plain(t1x, t1c, dxo, dco, dp, w1, b1, w2)
    b, n, ch = t1x.shape
    m = t1c.shape[1]
    hidden = w1.shape[0]
    dzx = (_col(dp[1], dxo) * dxo.float()).to(t1x.dtype)
    dzc = (_col(dp[3], dco) * dco.float()).to(t1x.dtype)
    db2 = (dzx.float().sum((0, 1)) + dzc.float().sum((0, 1))).to(w2.dtype)
    rps, splits = _wgrad_split(b * n, b * m, [(hidden, ch), (ch, hidden)],
                               _sms(t1x.device))
    f32 = torch.float32
    outs = [torch.empty_like(t1x), torch.empty_like(t1c),
            torch.empty_like(w1), torch.empty_like(b1), torch.empty_like(w2)]
    work = [_ws((b * n, ch), t1x), _ws((b * m, ch), t1x),
            _ws((b * n, hidden), t1x), _ws((b * m, hidden), t1x),
            _ws((b * n, hidden), t1x), _ws((b * m, hidden), t1x),
            _ws((splits * hidden * ch,), t1x, f32),
            _ws((splits * hidden,), t1x, f32)]
    tensors = [t1x, t1c, dxo, dco, dzx, dzc, w1, b1, w2.t().contiguous(),
               w1.t().contiguous()]
    for i, t in enumerate(tensors):
        if not t.is_contiguous() or t.dtype != t1x.dtype or not t.is_cuda:
            raise ValueError(f"mlp_bwd: tensor {i} must be a contiguous "
                             f"CUDA {t1x.dtype} tensor")
    fb._launch("mlp_bwd", t1x, [*tensors, *outs, *work], b, n, m, ch, hidden,
               rps, LN_EPS, counts=LAUNCHES)
    return (*outs, db2)


def s_attn_bwd(x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox, oc, lse_x, lse_c,
               *, num_heads: int):
    """The attention-backward phase; see s_attn_bwd_plain."""
    if not x.is_cuda:
        return s_attn_bwd_plain(x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox,
                                oc, lse_x, lse_c, num_heads=num_heads)
    b, n, ch = x.shape
    m = c.shape[1]
    h = num_heads
    dpx = (_col(dp[0], dt1x) * dt1x.float()).to(x.dtype)
    dpc = (_col(dp[2], dt1c) * dt1c.float()).to(x.dtype)
    dbp = (dpx.float().sum((0, 1)) + dpc.float().sum((0, 1))).to(wp.dtype)
    rps, splits = _wgrad_split(b * n, b * m, [(3 * ch, ch), (ch, ch)],
                               _sms(x.device))
    f32 = torch.float32
    outs = [torch.empty_like(x), torch.empty_like(c), torch.empty_like(wqkv),
            torch.empty_like(bqkv), torch.empty_like(wp)]
    work = [_ws((b * n, ch), x), _ws((b * m, ch), x),
            _ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x),
            _ws((b * n, ch), x, f32), _ws((b * m, ch), x, f32),
            _ws((b * h * n,), x, f32), _ws((b * h * m,), x, f32),
            _ws((b * n, 3 * ch), x), _ws((b * m, 3 * ch), x),
            _ws((b * n, ch), x, f32), _ws((b * m, ch), x, f32),
            _ws((splits * 3 * ch * ch,), x, f32),
            _ws((splits * 3 * ch,), x, f32)]
    tensors = [x, c, dt1x, dt1c, dpx, dpc, wqkv, bqkv, wqkv.t().contiguous(),
               wp.t().contiguous(), ox, oc]
    for i, t in enumerate(tensors):
        if not t.is_contiguous() or t.dtype != x.dtype or not t.is_cuda:
            raise ValueError(f"s_attn_bwd: tensor {i} must be a contiguous "
                             f"CUDA {x.dtype} tensor")
    fb._launch("s_attn_bwd", x, [*tensors, lse_x, lse_c, *outs, *work],
               b, n, m, ch, h, rps, fb.HEAD_DIM ** -0.5, LN_EPS,
               counts=LAUNCHES)
    return (*outs, dbp)


class _STrain(torch.autograd.Function):
    """Forward and backward of s_block_train across both token streams."""

    @staticmethod
    def forward(ctx, x, c, dp, num_heads, *params):
        x, c = x.contiguous(), c.contiguous()
        params = [p.contiguous() for p in params]
        xo, co, t1x, t1c, ox, oc, lx, lc = s_train_fwd(
            x, c, params, dp, num_heads=num_heads)
        ctx.save_for_backward(x, c, dp, t1x, t1c, ox, oc, lx, lc, *params)
        ctx.num_heads = num_heads
        return xo, co

    @staticmethod
    def backward(ctx, dxo, dco):
        x, c, dp, t1x, t1c, ox, oc, lx, lc, *params = ctx.saved_tensors
        wqkv, bqkv, wp, _, w1, b1, w2, _ = params
        dxo = (torch.zeros_like(x) if dxo is None
               else dxo.to(x.dtype).contiguous())
        dco = (torch.zeros_like(c) if dco is None
               else dco.to(c.dtype).contiguous())
        dt1x, dt1c, dw1, db1, dw2, db2 = mlp_bwd(t1x, t1c, dxo, dco, dp,
                                                 w1, b1, w2)
        dx, dc, dwqkv, dbqkv, dwp, dbp = s_attn_bwd(
            x, c, dt1x, dt1c, dp, wqkv, bqkv, wp, ox, oc, lx, lc,
            num_heads=ctx.num_heads)
        return (dx, dc, None, None, dwqkv, dbqkv, dwp, dbp, dw1, db1, dw2,
                db2)


def s_block_train(x, c, params, dp, *, num_heads: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable S block for training; see the module docstring."""
    return _STrain.apply(x, c, dp, num_heads, *params)
