"""PyTorch port, the S block's training-backward kernels' order of work on
the CPU: attn/fused_train.py::mlp_bwd_tiles_plain and
s_attn_bwd_tiles_plain (csrc/train_tc.cuh: LN2(t1), dz, dy and GELU(y)
rounded to the input type; LN1, qkv, dO, P and dS rounded; fp32 sums; the
weight gradients summed over row ranges in the reduce's fixed order), held
against the JAX package's pallas_train._mlp_bwd_call and _s_train_bwd_call
in interpret mode (as tests/test_torch_train_kernels.py runs the JAX
kernels) and against the port's fp32 plain phases (mlp_bwd_plain,
s_attn_bwd_plain), on the same numpy-seeded inputs: C = 64 with 2 heads,
N = 49, 64 and a ragged 200 (past a 64-row tile), M = 16, the cpe form on
a 6 x 8 image, and an empty image stream (the C block's MLP backward).

Tolerances: fp32 at 2e-4 (outputs dx / dc / dt1) and 5e-3 (weight
gradients), the JAX suite's (tests/test_pallas_train.py). bf16 (every
input rounded to bf16 first, so JAX sees the same numbers in fp32) at 3e-2
(max|ref| + |ref|) per tensor against JAX's fp32 result, as chip_smoke.py
holds the bf16 training kernels. The CUDA kernels are held against these
models on the card in tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_train as ft

C, H, M, IMG_W = 64, 2, 16, 8
TOL = {torch.float32: (2e-4, 5e-3), torch.bfloat16: (3e-2, 3e-2)}
DTYPES = [torch.float32, torch.bfloat16]
# a row range of the weight gradients shorter than the streams, so the
# models sum several ranges (the kernels' minimum is 128 rows)
RPS = 64


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _bf16(a):
    """a rounded to bf16, as fp32 numpy."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
        ).numpy()


def _batch(n):
    """Images per case: 2, or 8 where 2 n rows would not split into the
    8-row tiles the JAX kernels take."""
    return 2 if (2 * n) % 8 == 0 else 8


def _inputs(n, seed, cpe=False):
    """x, c, the folded S params (torch layout), DropPath scales, upstream
    gradients and the CPE pair (or None), as bf16-rounded fp32 numpy."""
    rng = np.random.RandomState(seed)
    B = _batch(n)
    r = lambda *s: _bf16(rng.randn(*s))
    lin = lambda o, i: [_bf16(rng.randn(o, i) / np.sqrt(i)),
                        _bf16(0.1 * rng.randn(o))]
    x, c = r(B, n, C), r(B, M, C)
    params = lin(3 * C, C) + lin(C, C) + lin(4 * C, C) + lin(C, 4 * C)
    dp = ((rng.rand(4, B) < 0.7) / 0.7).astype(np.float32)
    gx, gc = r(B, n, C), r(B, M, C)
    taps = (_bf16(0.3 * rng.randn(9, C)), _bf16(0.1 * rng.randn(C))) \
        if cpe else None
    return x, c, params, dp, gx, gc, taps


def _t(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _jp(params):
    """The params in the JAX package's (in, out) layout."""
    return tuple(jnp.asarray(p.T if p.ndim == 2 else p) for p in params)


def _check(got, want, dtype, names, n_out):
    """The first n_out tensors at the output tolerance, the rest at the
    gradient tolerance; bf16 per tensor in (max|ref| + |ref|)."""
    otol, gtol = TOL[dtype]
    assert len(got) == len(want) == len(names)
    for i, (g, w, name) in enumerate(zip(got, want, names)):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        tol = otol if i < n_out else gtol
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=name)
        else:
            lim = tol * (np.abs(w).max() + np.abs(w))
            assert (np.abs(g - w) <= lim).all(), (
                f"{name}: max err {np.abs(g - w).max():.3g}, max |ref| "
                f"{np.abs(w).max():.3g}")


MLP_NAMES = ["dt1x", "dt1c", "dW1", "db1", "dW2", "db2"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [49, 64, 200, 0],
                         ids=["n49", "n64", "n200", "empty"])
def test_mlp_bwd_tiles_match_jax_and_plain(n, dtype):
    """mlp_bwd_tiles_plain against JAX's _mlp_bwd_call and the fp32
    mlp_bwd_plain: dt1 of both streams and the four weight gradients. With
    no image tokens (the C block), JAX takes 8 zero rows there, which add
    nothing to any gradient."""
    x, c, params, dp, gx, gc, _ = _inputs(n, 11 + n)
    B = x.shape[0]
    w1, b1, w2 = params[4], params[5], params[6]
    rng = np.random.RandomState(n)
    t1x, t1c = _bf16(rng.randn(B, n, C)), _bf16(rng.randn(B, M, C))
    jx, jgx = (t1x, gx) if n else (np.zeros((8, C), np.float32),) * 2
    jout = pallas_train._mlp_bwd_call(
        jnp.asarray(jx.reshape(-1, C)), jnp.asarray(t1c.reshape(-1, C)),
        jnp.asarray(jgx.reshape(-1, C)), jnp.asarray(gc.reshape(-1, C)),
        jnp.asarray(dp), jnp.asarray(w1.T), jnp.asarray(b1),
        jnp.asarray(w2.T))
    jout = [np.asarray(a) for a in jout]
    jout = [jout[0].reshape(B, n, C) if n else None,
            jout[1].reshape(B, M, C), jout[2].T, jout[3], jout[4].T,
            jout[5]]
    dpt = torch.from_numpy(dp)
    args = [_t(a, dtype) for a in (t1x, t1c, gx, gc)]
    got = ft.mlp_bwd_tiles_plain(*args[:2], *args[2:], dpt,
                                 *(_t(a, dtype) for a in (w1, b1, w2)),
                                 rows_per_split=RPS)
    plain = ft.mlp_bwd_plain(*(_t(a, torch.float32) for a in (
        t1x, t1c, gx, gc)), dpt, *(_t(a, torch.float32)
                                   for a in (w1, b1, w2)))
    keep = slice(0 if n else 1, None)  # no image stream: no dt1x
    _check(got[keep], jout[keep], dtype, MLP_NAMES[keep], 2 - keep.start)
    _check(got[keep], plain[keep], dtype, MLP_NAMES[keep], 2 - keep.start)


S_NAMES = ["dx", "dc", "dWqkv", "dbqkv", "dWp", "dbp", "dW1", "db1", "dW2",
           "db2"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,cpe", [(49, False), (64, False), (200, False),
                                   (48, True)],
                         ids=["n49", "n64", "n200", "cpe"])
def test_s_attn_bwd_tiles_match_jax_and_plain(n, cpe, dtype):
    """mlp_bwd_tiles_plain then s_attn_bwd_tiles_plain (the S block's
    backward as the kernels order it) against JAX's _s_train_bwd_call and
    the fp32 plain phases, on t1, o and the log-sum-exp of the fp32 plain
    forward: dx, dc and every weight gradient (with ``cpe``, x before the
    6 x 8 image's CPE and the taps' and bias's gradients too)."""
    x, c, params, dp, gx, gc, taps = _inputs(n, 21 + n, cpe)
    dpt = torch.from_numpy(dp)
    kw = {"num_heads": H}
    if cpe:
        kw.update(img_w=IMG_W)
    f32 = [_t(a, torch.float32) for a in (x, c, *params)]
    cpe32 = None if taps is None else [_t(a, torch.float32) for a in taps]
    fwd = ft.s_train_fwd_plain(f32[0], f32[1], f32[2:], dpt, cpe=cpe32, **kw)
    _, _, t1x, t1c, ox, oc, lx, lc = fwd

    jcpe = None if taps is None else tuple(jnp.asarray(a) for a in taps)
    jdx, jdc, jdp, jdcpe = pallas_train._s_train_bwd_call(
        jnp.asarray(x), jnp.asarray(c), _jp(params), jcpe,
        tuple(jnp.asarray(dp[i]) for i in range(4)),
        jnp.asarray(t1x.reshape(-1, C).numpy()),
        jnp.asarray(t1c.reshape(-1, C).numpy()), jnp.asarray(gx),
        jnp.asarray(gc), (C // H) ** -0.5, H, IMG_W if cpe else 0, cpe)
    jdp = [np.asarray(a) for a in jdp]
    want = ([np.asarray(jdx), np.asarray(jdc)]
            + [a.T if a.ndim == 2 else a for a in jdp[:4]]
            + [a.T if a.ndim == 2 else a for a in jdp[4:]])
    if cpe:
        want += [np.asarray(a) for a in jdcpe]

    def run(dt, mlp, attn, **extra):
        p = [_t(a, dt) for a in params]
        cp = None if taps is None else [_t(a, dt) for a in taps]
        m = mlp(t1x.to(dt), t1c.to(dt), _t(gx, dt), _t(gc, dt), dpt, p[4],
                p[5], p[6], **extra)
        a = attn(_t(x, dt), _t(c, dt), m[0], m[1], dpt, p[0], p[1], p[2],
                 ox.to(dt), oc.to(dt), lx, lc, cpe=cp, **kw, **extra)
        return list(a[:6]) + list(m[2:]) + ([] if taps is None
                                            else list(a[6:]))

    names = S_NAMES + (["dtaps", "dbias"] if cpe else [])
    got = run(dtype, ft.mlp_bwd_tiles_plain, ft.s_attn_bwd_tiles_plain,
              rows_per_split=RPS)
    plain = run(torch.float32, ft.mlp_bwd_plain, ft.s_attn_bwd_plain)
    _check(got, want, dtype, names, 2)
    _check(got, plain, dtype, names, 2)


def test_wgrad_ranges_sum_in_order():
    """The models' weight gradients over row ranges equal one product over
    all rows up to fp32 rounding, with every range counted once (a ragged
    last range, both streams)."""
    rng = np.random.RandomState(5)
    g = [torch.from_numpy(rng.randn(r, 24).astype(np.float32))
         for r in (200, 16)]
    a = [torch.from_numpy(rng.randn(r, 8).astype(np.float32))
         for r in (200, 16)]
    dw, db = ft._wgrad_ranges(list(zip(g, a)), 64)
    torch.testing.assert_close(dw, torch.cat(g).t() @ torch.cat(a),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, torch.cat(g).sum(0), rtol=1e-5,
                               atol=1e-5)
