"""PyTorch port, the D block's training forward's order of work on the CPU:
attn/fused_train.py::dca_train_fwd_tiles_plain (csrc/dca_train.cu's
lm_dca_train_fwd on block_tc.cuh's k_qkv_wg with each stream's weights,
attn_tc.cuh's k_dca_tc + k_dca_merge in their log-sum-exp instance and the
training instance of k_tail_wg: LN1 and qkv rounded to the input type, the
x direction's online softmax over meta-key tiles of 16 with P normalised
and rounded before P v2, the c direction's per-warp partials merged per
tile and the tiles merged in a fixed order, each row's log-sum-exp in
natural-log units, t1 = t + s1 (o Wp^T + bp) rounded as it is written, s2
applied to each GELU chunk before its rounding), held against the JAX
package's pallas_train._dca_train_fwd_call in interpret mode (x_out,
c_out, t1x, t1c), and its o and log-sum-exp against the fp32 plain forward
(dca_train_fwd_plain's _attn_fwd), on the numpy-seeded inputs of
tests/test_torch_dca_bwd_tiles.py: C = 64 with 2 heads, M = 16, N = 49, 64
and a ragged 200 (past the 128- / 64-row attention tiles), the cpe form on
a 6 x 8 image and a D2 block through its weight permutation.

Tolerances: fp32 at 2e-4 (the JAX suite's output tolerance,
tests/test_pallas_train.py); bf16 (inputs rounded to bf16 first, so JAX
sees the same numbers in fp32) at 3e-2 (max|ref| + |ref|) per tensor
against JAX's fp32 result, as tests/test_torch_train_fwd_tiles.py holds
the S block's forward. The CUDA kernels are held against this model on
the card in tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales
from tests.test_torch_dca_bwd_tiles import _inputs
from tests.test_torch_train_tiles import C, DTYPES, H, IMG_W, M, _check, _jp, _t

FWD_NAMES = ["x_out", "c_out", "t1x", "t1c"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _kw(n, cpe):
    scale_x, scale_c = dca_scales(n, M, C)
    kw = {"num_heads": H, "scale_x": scale_x, "scale_c": scale_c}
    if cpe:
        kw.update(img_w=IMG_W)
    return kw


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,cpe,d2", [(49, False, False), (64, False, False),
                                      (200, False, False), (48, True, False),
                                      (64, False, True)],
                         ids=["n49", "n64", "n200", "cpe", "d2"])
def test_dca_train_fwd_tiles_match_jax_and_plain(n, cpe, d2, dtype):
    """dca_train_fwd_tiles_plain against JAX's _dca_train_fwd_call (x_out,
    c_out, t1x, t1c) and the fp32 plain forward (the same four, then o and
    the log-sum-exp of both directions); with ``cpe`` x is before the 6 x 8
    image's CPE, with ``d2`` the weights are D2's [Wq|Wq|Wv1] /
    [Wk|Wk|Wv2]."""
    x, c, params, dp, _, _, taps = _inputs(n, 61 + n, cpe, d2)
    dpt = torch.from_numpy(dp)
    kw = _kw(n, cpe)
    jcpe = None if taps is None else tuple(jnp.asarray(a) for a in taps)
    jx, jc, jt1x, jt1c = pallas_train._dca_train_fwd_call(
        jnp.asarray(x), jnp.asarray(c), _jp(params), jcpe,
        tuple(jnp.asarray(dp[i]) for i in range(4)), kw["scale_x"],
        kw["scale_c"], H, IMG_W if cpe else 0, cpe)
    want = [np.asarray(jx), np.asarray(jc),
            np.asarray(jt1x).reshape(x.shape),
            np.asarray(jt1c).reshape(c.shape)]

    def run(fn, dt):
        cp = None if taps is None else [_t(a, dt) for a in taps]
        return fn(_t(x, dt), _t(c, dt), [_t(a, dt) for a in params], dpt,
                  cpe=cp, **kw)

    got = run(ft.dca_train_fwd_tiles_plain, dtype)
    plain = run(ft.dca_train_fwd_plain, torch.float32)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in plain]
    _check(got[:4], want, dtype, FWD_NAMES, 4)
    _check(got[:4], [t.numpy() for t in plain[:4]], dtype, FWD_NAMES, 4)
    _check(got[4:], [t.float().numpy() for t in plain[4:]], dtype,
           ["o_x", "o_c", "lse_x", "lse_c"], 4)


@pytest.mark.parametrize("n", [49, 200], ids=["n49", "n200"])
def test_dca_train_fwd_tiles_lse_is_natural_log(n):
    """The model's log-sum-exps are in natural-log units, as the attention
    backward (lm_dca_attn_bwd) takes them: exp(q k^T scale - lse) sums to
    1 over the keys of every query in both directions (image queries over
    the meta keys with scale_x, meta queries over the image keys with
    scale_c), in bf16 (from the model's own rounded q and k) as in fp32,
    and P v reproduces o to the model's rounding."""
    x, c, params, dp, _, _, _ = _inputs(n, 71 + n)
    dpt = torch.from_numpy(dp)
    kw = _kw(n, False)
    for dt in DTYPES:
        p = [_t(a, dt) for a in params]
        xt, ct = _t(x, dt), _t(c, dt)
        out = ft.dca_train_fwd_tiles_plain(xt, ct, p, dpt, **kw)
        ox, oc, lx, lc = out[4:]
        qkv = [(ft._norm(t).to(dt).float() @ w.float().t()
                + b.float()).to(dt).chunk(3, -1)
               for t, w, b in ((xt, p[0], p[1]), (ct, p[2], p[3]))]
        (q1, k1, v1), (q2, k2, v2) = qkv
        for q, k, v, o, lse, sc in ((q1, k2, v2, ox, lx, kw["scale_x"]),
                                    (q2, k1, v1, oc, lc, kw["scale_c"])):
            q, k, v = (ft._heads(u, H) for u in (q, k, v))
            s = torch.einsum("bnhd,bmhd->bhnm", q, k) * sc
            prob = torch.exp(s - lse[..., None])
            torch.testing.assert_close(prob.sum(-1), torch.ones_like(lse),
                                       rtol=0, atol=1e-5)
            tol = 1e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(
                torch.einsum("bhnm,bmhd->bnhd", prob, v).flatten(2),
                o.float(), rtol=tol, atol=tol)
