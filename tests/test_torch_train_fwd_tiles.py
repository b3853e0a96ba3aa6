"""PyTorch port, the S block's training forward's order of work on the CPU:
attn/fused_train.py::s_train_fwd_tiles_plain (csrc/s_train.cu's
lm_s_train_fwd on block_tc.cuh's k_qkv_wg, attn_tc.cuh's k_mhsa_tc and the
training instance of k_tail_wg: LN1 and qkv rounded to the input type, the
32-key online softmax with P rounded before P v, each query's log-sum-exp
in natural-log units, t1 = t + s1 (o Wp^T + bp) rounded as it is written,
s2 applied to each GELU chunk before its rounding), held against the JAX
package's pallas_train._s_train_fwd_call in interpret mode (x_out, c_out,
t1x, t1c), and its o and log-sum-exp against the fp32 plain forward
(s_train_fwd_plain's _attn_fwd) and a logsumexp of the scaled scores, on
the numpy-seeded inputs of tests/test_torch_train_tiles.py: C = 64 with 2
heads, M = 16, N = 49, 64 and a ragged 200, the cpe form on a 6 x 8 image.

Tolerances: fp32 at 2e-4 (the JAX suite's output tolerance,
tests/test_pallas_train.py); bf16 (inputs rounded to bf16 first, so JAX
sees the same numbers in fp32) at 3e-2 (max|ref| + |ref|) per tensor
against JAX's fp32 result, as chip_smoke.py holds the bf16 training
kernels. The CUDA kernels are held against this model on the card in
tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_train as ft
from tests.test_torch_train_tiles import (C, DTYPES, H, IMG_W, _check,
                                          _inputs, _jp, _t)

FWD_NAMES = ["x_out", "c_out", "t1x", "t1c"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _fwd_case(n, cpe, dtype, seed):
    """(the tile model's eight outputs, JAX's four, the fp32 plain
    forward's eight, the model's own q / k in fp32 per stream)."""
    x, c, params, dp, _, _, taps = _inputs(n, seed, cpe)
    dpt = torch.from_numpy(dp)
    kw = {"num_heads": H}
    if cpe:
        kw.update(img_w=IMG_W)
    jcpe = None if taps is None else tuple(jnp.asarray(a) for a in taps)
    jx, jc, jt1x, jt1c = pallas_train._s_train_fwd_call(
        jnp.asarray(x), jnp.asarray(c), _jp(params), jcpe,
        tuple(jnp.asarray(dp[i]) for i in range(4)), (C // H) ** -0.5, H,
        IMG_W if cpe else 0, cpe)
    want = [np.asarray(jx), np.asarray(jc),
            np.asarray(jt1x).reshape(x.shape),
            np.asarray(jt1c).reshape(c.shape)]

    def run(fn, dt):
        cp = None if taps is None else [_t(a, dt) for a in taps]
        return fn(_t(x, dt), _t(c, dt), [_t(a, dt) for a in params], dpt,
                  cpe=cp, **kw)

    return (run(ft.s_train_fwd_tiles_plain, dtype), want,
            run(ft.s_train_fwd_plain, torch.float32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,cpe", [(49, False), (64, False), (200, False),
                                   (48, True)],
                         ids=["n49", "n64", "n200", "cpe"])
def test_s_train_fwd_tiles_match_jax_and_plain(n, cpe, dtype):
    """s_train_fwd_tiles_plain against JAX's _s_train_fwd_call (x_out,
    c_out, t1x, t1c) and the fp32 plain forward (the same four, then o and
    the log-sum-exp of both streams)."""
    got, want, plain = _fwd_case(n, cpe, dtype, 31 + n)
    _check(got[:4], want, dtype, FWD_NAMES, 4)
    _check(got[:4], [t.numpy() for t in plain[:4]], dtype, FWD_NAMES, 4)
    otol = 2e-4 if dtype == torch.float32 else 3e-2
    for name, g, w in zip(["o_x", "o_c", "lse_x", "lse_c"], got[4:],
                          plain[4:]):
        w = w.float()
        lim = otol * ((w.abs().max() + w.abs()) if dtype == torch.bfloat16
                      else 1.0)
        assert ((g.float() - w).abs() <= lim).all(), name


@pytest.mark.parametrize("n", [49, 200], ids=["n49", "n200"])
def test_s_train_fwd_tiles_lse_is_natural_log(n):
    """The model's log-sum-exp is in natural-log units, as the attention
    backward (train_tc.cuh) takes it: exp(q k^T scale - lse) sums to 1 over
    the keys of every query, in bf16 (from the model's own rounded q and
    k) as in fp32, and P v reproduces o to the model's rounding."""
    x, c, params, dp, _, _, _ = _inputs(n, 41 + n)
    dpt = torch.from_numpy(dp)
    for dt in DTYPES:
        p = [_t(a, dt) for a in params]
        xo, co, t1x, t1c, ox, oc, lx, lc = ft.s_train_fwd_tiles_plain(
            _t(x, dt), _t(c, dt), p, dpt, num_heads=H)
        for t, o, lse in ((_t(x, dt), ox, lx), (_t(c, dt), oc, lc)):
            qkv = (ft._norm(t).to(dt).float() @ p[0].float().t()
                   + p[1].float()).to(dt)
            q, k, v = (ft._heads(u, H) for u in qkv.chunk(3, -1))
            s = torch.einsum("bnhd,bmhd->bhnm", q, k) * (C // H) ** -0.5
            prob = torch.exp(s - lse[..., None])
            torch.testing.assert_close(prob.sum(-1),
                                       torch.ones_like(lse), rtol=0,
                                       atol=1e-5)
            tol = 1e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(
                torch.einsum("bhnm,bmhd->bnhd", prob, v).flatten(2),
                o.float(), rtol=tol, atol=tol)
