"""PyTorch port, the D block's attention backward's order of work on the
CPU: attn/fused_train.py::dca_attn_bwd_tiles_plain (csrc/dca_train.cu's
lm_dca_attn_bwd on block_tc.cuh's k_qkv_wg with each stream's weights,
train_tc.cuh's k_rowmm_wg, the cross-attention backward k_dca_bwd_tc and
k_wgrad_tc: LN1, qkv1 / qkv2, dO, P and dS rounded to the input type, fp32
sums, the image rows' sums for dq2 / dk2 / dv2 and each stream's weight
gradients over row ranges), after mlp_bwd_tiles_plain, held against the
JAX package's pallas_train._dca_train_bwd_call in interpret mode and
against the port's fp32 plain phases (mlp_bwd_plain, dca_attn_bwd_plain),
on the forward's t1, o and log-sum-exp from the fp32 dca_train_fwd_plain:
C = 64 with 2 heads, M = 16, N = 49, 64 and a ragged 200, the cpe form on a
6 x 8 image and a D2 block through its weight permutation ([Wq|Wq|Wv1] /
[Wk|Wk|Wv2]). Also k_dca_bwd_tc's split of the image rows into ranges.

Tolerances: fp32 at 2e-4 (dx / dc) and 5e-3 (weight gradients), the JAX
suite's (tests/test_pallas_train.py); bf16 (inputs rounded to bf16 first)
at 3e-2 (max|ref| + |ref|) per tensor against JAX's fp32 result, as
tests/test_torch_train_tiles.py holds the S block's backward."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales
from tests.test_torch_train_tiles import (C, DTYPES, H, IMG_W, M, RPS,
                                          _batch, _bf16, _check, _jp, _t)

NAMES = ["dx", "dc", "dWqkv1", "dbqkv1", "dWqkv2", "dbqkv2", "dWpx", "dbpx",
         "dWpc", "dbpc", "dW1", "db1", "dW2", "db2"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _inputs(n, seed, cpe=False, d2=False):
    """x, c, the folded D params (torch layout; D2's permuted), DropPath
    scales, upstream gradients and the CPE pair (or None), as bf16-rounded
    fp32 numpy."""
    rng = np.random.RandomState(seed)
    B = _batch(n)
    r = lambda *s: _bf16(rng.randn(*s))
    lin = lambda o, i: [_bf16(rng.randn(o, i) / np.sqrt(i)),
                        _bf16(0.1 * rng.randn(o))]
    x, c = r(B, n, C), r(B, M, C)
    if d2:  # q, v1 from x; k, v2 from c: [Wq|Wq|Wv1], [Wk|Wk|Wv2]
        (wq, bq), (wv1, bv1) = lin(C, C), lin(C, C)
        (wk, bk), (wv2, bv2) = lin(C, C), lin(C, C)
        attn = [np.concatenate([wq, wq, wv1]), np.concatenate([bq, bq, bv1]),
                np.concatenate([wk, wk, wv2]), np.concatenate([bk, bk, bv2])]
    else:
        attn = lin(3 * C, C) + lin(3 * C, C)
    params = attn + lin(C, C) + lin(C, C) + lin(4 * C, C) + lin(C, 4 * C)
    dp = ((rng.rand(4, B) < 0.7) / 0.7).astype(np.float32)
    gx, gc = r(B, n, C), r(B, M, C)
    taps = (_bf16(0.3 * rng.randn(9, C)), _bf16(0.1 * rng.randn(C))) \
        if cpe else None
    return x, c, params, dp, gx, gc, taps


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,cpe,d2", [(49, False, False), (64, False, False),
                                      (200, False, False), (48, True, False),
                                      (64, False, True)],
                         ids=["n49", "n64", "n200", "cpe", "d2"])
def test_dca_attn_bwd_tiles_match_jax_and_plain(n, cpe, d2, dtype):
    """mlp_bwd_tiles_plain then dca_attn_bwd_tiles_plain (the D block's
    backward as the kernels order it) against JAX's _dca_train_bwd_call and
    the fp32 plain phases: dx, dc and every weight gradient (with ``cpe``,
    x before the 6 x 8 image's CPE and the taps' and bias's gradients
    too)."""
    x, c, params, dp, gx, gc, taps = _inputs(n, 51 + n, cpe, d2)
    dpt = torch.from_numpy(dp)
    scale_x, scale_c = dca_scales(n, M, C)
    kw = {"num_heads": H, "scale_x": scale_x, "scale_c": scale_c}
    if cpe:
        kw.update(img_w=IMG_W)
    f32 = [_t(a, torch.float32) for a in (x, c, *params)]
    cpe32 = None if taps is None else [_t(a, torch.float32) for a in taps]
    _, _, t1x, t1c, ox, oc, lx, lc = ft.dca_train_fwd_plain(
        f32[0], f32[1], f32[2:], dpt, cpe=cpe32, **kw)

    jcpe = None if taps is None else tuple(jnp.asarray(a) for a in taps)
    jdx, jdc, jdp, jdcpe = pallas_train._dca_train_bwd_call(
        jnp.asarray(x), jnp.asarray(c), _jp(params), jcpe,
        tuple(jnp.asarray(dp[i]) for i in range(4)),
        jnp.asarray(t1x.reshape(-1, C).numpy()),
        jnp.asarray(t1c.reshape(-1, C).numpy()), jnp.asarray(gx),
        jnp.asarray(gc), scale_x, scale_c, H, IMG_W if cpe else 0, cpe)
    want = [np.asarray(jdx), np.asarray(jdc)] + [
        np.asarray(a).T if np.ndim(a) == 2 else np.asarray(a) for a in jdp]
    if cpe:
        want += [np.asarray(a) for a in jdcpe]

    def run(dt, mlp, attn, **extra):
        p = [_t(a, dt) for a in params]
        cp = None if taps is None else [_t(a, dt) for a in taps]
        g = mlp(t1x.to(dt), t1c.to(dt), _t(gx, dt), _t(gc, dt), dpt, p[8],
                p[9], p[10], **extra)
        a = attn(_t(x, dt), _t(c, dt), g[0], g[1], dpt, p[0], p[1], p[2],
                 p[3], p[4], p[6], ox.to(dt), oc.to(dt), lx, lc, cpe=cp,
                 **kw, **extra)
        return list(a[:10]) + list(g[2:]) + ([] if taps is None
                                             else list(a[10:]))

    names = NAMES + (["dtaps", "dbias"] if cpe else [])
    got = run(dtype, ft.mlp_bwd_tiles_plain, ft.dca_attn_bwd_tiles_plain,
              rows_per_split=RPS)
    plain = run(torch.float32, ft.mlp_bwd_plain, ft.dca_attn_bwd_plain)
    _check(got, want, dtype, names, 2)
    _check(got, plain, dtype, names, 2)


@pytest.mark.parametrize("n,m,dtype,bh,want", [
    (3136, 16, torch.bfloat16, 128, (5, 5)),   # lemevit_tiny stage 1
    (784, 16, torch.bfloat16, 256, (3, 3)),    # lemevit_tiny stage 2
    (3136, 16, torch.float32, 128, (10, 5)),
    (200, 16, torch.bfloat16, 2, (1, 2)),      # few (image, head) pairs
    (784, 32, torch.bfloat16, 256, (1, 7)),    # two meta tiles: a chunk each
])
def test_dca_bwd_chunks(n, m, dtype, bh, want):
    """k_dca_bwd_tc's (chunks, ranges): about four CTAs per multiprocessor
    (132 here), every chunk of image rows in exactly one range, one chunk
    a range past 16 meta tokens."""
    chunks, ranges = ft._dca_bwd_chunks(n, bh, m, dtype, 132)
    assert (chunks, ranges) == want
    total = -(-n // ft.DCA_BWD_ROWS[dtype])
    assert (ranges - 1) * chunks < total <= ranges * chunks
