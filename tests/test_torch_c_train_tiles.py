"""PyTorch port, the C block's training kernels' order of work on the CPU:
attn/fused_train.py::c_train_fwd_tiles_plain (csrc/c_train.cu's
lm_c_train_fwd on block_tc.cuh's k_qkv_wg with two streams of different
widths, attn_tc.cuh's c-direction k_dca_tc + the log-sum-exp instance of
k_dca_merge and the training instance of k_tail_wg on the meta rows: LN1,
kv and q rounded to the input type, per-warp partial softmaxes merged per
tile and the tiles merged in a fixed order, each meta row's log-sum-exp
in natural-log units, t1c rounded as it is written, s2c applied to each
GELU chunk before its rounding) and c_attn_bwd_tiles_plain (lm_c_attn_bwd
on k_qkv_wg's LN1-rows instance, train_tc.cuh's k_rowmm_wg, the
c-direction k_dca_bwd_tc and k_wgrad_tc: dO, P and dS rounded, fp32 sums,
the image rows' sums for dq and each stream's weight gradients over row
ranges, dbp among them), after mlp_bwd_tiles_plain on the meta stream
alone, held against the JAX package's pallas_train._c_train_fwd_call /
_c_train_bwd_call in interpret mode and against the port's fp32 plain
phases (c_train_fwd_plain, mlp_bwd_plain, c_attn_bwd_plain) on the same
numpy-seeded inputs: C = 64 with 2 heads, M = 16, N = 49, 64 and a ragged
200 (past the 128- / 64-row tiles), the cpe form on a 6 x 8 image, and M =
24 (past one meta tile of 16; the JAX kernels take M a multiple of 8).

Tolerances: fp32 at 2e-4 (outputs, dx / dc) and 5e-3 (weight gradients),
the JAX suite's (tests/test_pallas_train.py); bf16 (inputs rounded to bf16
first, so JAX sees the same numbers in fp32) at 3e-2 (max|ref| + |ref|)
per tensor against JAX's fp32 result, as tests/test_torch_train_tiles.py
holds the S block's kernels. The CUDA kernels are held against these
models on the card in tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_train as ft
from tests.test_torch_train_tiles import (C, DTYPES, H, IMG_W, RPS, _batch,
                                          _bf16, _check, _jp, _t)

SCALE = (C // H) ** -0.5
FWD_NAMES = ["c_out", "t1c"]
BWD_NAMES = ["dx", "dc", "dWq", "dbq", "dWkv", "dbkv", "dWp", "dbp", "dW1",
             "db1", "dW2", "db2"]
# (N, M, cpe): N = 49, 64 and a ragged 200, the cpe form on a 6 x 8 image,
# two meta tiles (M = 24)
CASES = [(49, 16, False), (64, 16, False), (200, 16, False), (48, 16, True),
         (64, 24, False)]
IDS = ["n49", "n64", "n200", "cpe", "m24"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _inputs(n, m, seed, cpe=False):
    """x, c, the folded C params (torch layout), DropPath scales, the
    upstream gradient of c and the CPE pair (or None), as bf16-rounded fp32
    numpy."""
    rng = np.random.RandomState(seed)
    B = _batch(n)
    r = lambda *s: _bf16(rng.randn(*s))  # noqa: E731
    lin = lambda o, i: [_bf16(rng.randn(o, i) / np.sqrt(i)),  # noqa: E731
                        _bf16(0.1 * rng.randn(o))]
    x, c = r(B, n, C), r(B, m, C)
    params = lin(C, C) + lin(2 * C, C) + lin(C, C) + lin(4 * C, C) + lin(
        C, 4 * C)
    dp = ((rng.rand(4, B) < 0.7) / 0.7).astype(np.float32)
    gc = r(B, m, C)
    taps = (_bf16(0.3 * rng.randn(9, C)), _bf16(0.1 * rng.randn(C))) \
        if cpe else None
    return x, c, params, dp, gc, taps


def _jax_args(dp, taps):
    jcpe = None if taps is None else tuple(jnp.asarray(a) for a in taps)
    return jcpe, tuple(jnp.asarray(dp[i]) for i in range(4))


def _kw(cpe):
    return {"num_heads": H, **({"img_w": IMG_W} if cpe else {})}


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m,cpe", CASES, ids=IDS)
def test_c_train_fwd_tiles_match_jax_and_plain(n, m, cpe, dtype):
    """c_train_fwd_tiles_plain against JAX's _c_train_fwd_call (c_out, t1c)
    and the fp32 c_train_fwd_plain (the same two, then o and each meta
    row's log-sum-exp); with ``cpe`` x is before the 6 x 8 image's CPE,
    which feeds k and v alone."""
    x, c, params, dp, _, taps = _inputs(n, m, 91 + n + m, cpe)
    dpt = torch.from_numpy(dp)
    jcpe, jdp = _jax_args(dp, taps)
    jco, jt1c = pallas_train._c_train_fwd_call(
        jnp.asarray(x), jnp.asarray(c), _jp(params), jcpe, jdp, SCALE, H,
        IMG_W if cpe else 0, cpe)
    want = [np.asarray(jco), np.asarray(jt1c).reshape(c.shape)]

    def run(fn, dt):
        cp = None if taps is None else [_t(a, dt) for a in taps]
        return fn(_t(x, dt), _t(c, dt), [_t(a, dt) for a in params], dpt,
                  cpe=cp, **_kw(cpe))

    got = run(ft.c_train_fwd_tiles_plain, dtype)
    plain = run(ft.c_train_fwd_plain, torch.float32)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in plain]
    assert [t.dtype for t in got] == [dtype] * 3 + [torch.float32]
    _check(got[:2], want, dtype, FWD_NAMES, 2)
    _check(got, [t.float().numpy() for t in plain], dtype,
           FWD_NAMES + ["o", "lse"], 4)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m,cpe", CASES, ids=IDS)
def test_c_attn_bwd_tiles_match_jax_and_plain(n, m, cpe, dtype):
    """mlp_bwd_tiles_plain on the meta stream alone, then
    c_attn_bwd_tiles_plain (the C block's backward as the kernels order it)
    against JAX's _c_train_bwd_call and the fp32 plain phases: dx (through
    k / v alone), dc and every weight gradient (with ``cpe``, x before the
    6 x 8 image's CPE and the taps' and bias's gradients too), on the fp32
    plain forward's t1c, o and log-sum-exp."""
    x, c, params, dp, gc, taps = _inputs(n, m, 51 + n + m, cpe)
    dpt = torch.from_numpy(dp)
    kw = _kw(cpe)
    f32 = [_t(a, torch.float32) for a in (x, c, *params)]
    cpe32 = None if taps is None else [_t(a, torch.float32) for a in taps]
    _, t1c, o, lse = ft.c_train_fwd_plain(f32[0], f32[1], f32[2:], dpt,
                                          cpe=cpe32, **kw)

    jcpe, jdp = _jax_args(dp, taps)
    jdx, jdc, jdparams, jdcpe = pallas_train._c_train_bwd_call(
        jnp.asarray(x), jnp.asarray(c), _jp(params), jcpe, jdp,
        jnp.asarray(t1c.reshape(-1, C).numpy()), jnp.asarray(gc), SCALE, H,
        IMG_W if cpe else 0, cpe)
    want = [np.asarray(jdx), np.asarray(jdc)] + [
        np.asarray(a).T if np.ndim(a) == 2 else np.asarray(a)
        for a in jdparams]
    if cpe:
        want += [np.asarray(a) for a in jdcpe]

    def run(dt, mlp, attn, **extra):
        p = [_t(a, dt) for a in params]
        cp = None if taps is None else [_t(a, dt) for a in taps]
        none = torch.zeros((x.shape[0], 0, C), dtype=dt)
        g = mlp(none, t1c.to(dt), none, _t(gc, dt), dpt, p[6], p[7], p[8],
                **extra)
        a = attn(_t(x, dt), _t(c, dt), g[1], dpt, *p[:5], o.to(dt), lse,
                 cpe=cp, **kw, **extra)
        return list(a[:8]) + list(g[2:]) + ([] if taps is None
                                            else list(a[8:]))

    names = BWD_NAMES + (["dtaps", "dbias"] if cpe else [])
    got = run(dtype, ft.mlp_bwd_tiles_plain, ft.c_attn_bwd_tiles_plain,
              rows_per_split=RPS)
    plain = run(torch.float32, ft.mlp_bwd_plain, ft.c_attn_bwd_plain)
    _check(got, want, dtype, names, 2)
    _check(got, plain, dtype, names, 2)


@pytest.mark.parametrize("n,m", [(49, 16), (200, 24)], ids=["n49", "n200"])
def test_c_train_fwd_tiles_lse_is_natural_log(n, m):
    """The model's log-sum-exps are in natural-log units, as the attention
    backward (lm_c_attn_bwd) takes them: exp(q k^T scale - lse) sums to 1
    over the image keys of every meta query, in bf16 (from the model's own
    rounded q and k) as in fp32, and P v reproduces o to the model's
    rounding."""
    x, c, params, dp, _, _ = _inputs(n, m, 71 + n)
    dpt = torch.from_numpy(dp)
    for dt in DTYPES:
        p = [_t(a, dt) for a in params]
        xt, ct = _t(x, dt), _t(c, dt)
        _, _, o, lse = ft.c_train_fwd_tiles_plain(xt, ct, p, dpt,
                                                  num_heads=H)
        k, v = (ft._norm(xt).to(dt).float() @ p[2].float().t()
                + p[3].float()).to(dt).chunk(2, -1)
        q = (ft._norm(ct).to(dt).float() @ p[0].float().t()
             + p[1].float()).to(dt)
        q, k, v = (ft._heads(u, H) for u in (q, k, v))
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) * SCALE
        prob = torch.exp(s - lse[..., None])
        torch.testing.assert_close(prob.sum(-1), torch.ones_like(lse),
                                   rtol=0, atol=1e-5)
        tol = 1e-5 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(
            torch.einsum("bhnm,bmhd->bnhd", prob, v).flatten(2), o.float(),
            rtol=tol, atol=tol)
