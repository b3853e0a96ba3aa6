"""PyTorch port, the S and D block kernels' order of work on the CPU:
attn/fused_block.py::s_block_tiles_plain and dca_block_tiles_plain
(csrc/block_tc.cuh's k_qkv_wg and k_tail_wg around attn_tc.cuh's attention
tiles: LN1 rounded to the input type before the qkv product, qkv rounded,
the attention as mhsa_tiles_plain / dca_tiles_plain, LN2 rounded, each
128-wide hidden chunk rounded after its GELU, fp32 sums), held against the
JAX package's fused Pallas blocks pallas_block.s_block / dca_block in
interpret mode (as tests/test_torch_port_blocks.py runs them) on the same
numpy-seeded inputs: C = 64 with 2 heads, N = 49 and 64 and a ragged 200
(past the 128- / 64-row attention tiles of bf16 / fp32), M = 16, 32 and
128, D2 through the weight permutation, and the cpe form.

Tolerances: fp32 at 3e-5, the JAX suite's own for fused blocks
(tests/test_pallas.py:216-392). bf16 (the same numbers handed to JAX in
fp32) at 2e-2 (1 + |ref|) against JAX's fp32 result, as
tests/test_torch_attn_tiles.py holds the attention tiles: the model rounds
to bf16's 8 significant bits at five places (LN1, qkv, P, LN2, each hidden
chunk) and once more at the output, whose values reach ~6 here, so the
output's own rounding alone is up to 2^-9 of them; these cases measure at
most 9e-3. The CUDA kernels are held against these models on the card in
tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import dca_scales

C, H = 64, 2
TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]
_JAX = {}  # JAX's fp32 result per case, shared by the two dtypes' tests


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _lin(rng, out, inp):
    return [rng.randn(out, inp) / np.sqrt(inp), 0.1 * rng.randn(out)]


def _ln(rng):
    return [1 + 0.1 * rng.randn(C), 0.1 * rng.randn(C)]


def _case(kind, n, m, cpe, d2=False):
    """(x, c, params, cpe pair or None) as fp32 numpy, seeded by the case,
    every value rounded to bf16 first so both dtypes see the same
    numbers. D2: the D kernel's [Wq|Wq|Wv1] / [Wk|Wk|Wv2] permutation."""
    rng = np.random.RandomState(n * 7 + m + ord(kind) + 100 * cpe + 50 * d2)
    x = rng.randn(2, n, C)
    c = rng.randn(2, m, C)
    if kind == "s":
        p = _ln(rng) + _lin(rng, 3 * C, C) + _lin(rng, C, C)
    else:
        p = _ln(rng) + _lin(rng, 3 * C, C) + _lin(rng, 3 * C, C)
        if d2:
            for i in (2, 4):  # q1 = k1 and q2 = k2
                p[i][C:2 * C], p[i + 1][C:2 * C] = p[i][:C], p[i + 1][:C]
        p += _lin(rng, C, C) + _lin(rng, C, C)
    p += _ln(rng) + _lin(rng, 2 * C, C) + _lin(rng, C, 2 * C)
    cp = [0.3 * rng.randn(9, C), 0.1 * rng.randn(C)] if cpe else None
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa
        torch.bfloat16).float().numpy()
    return (bf(x), bf(c), [bf(a) for a in p],
            None if cp is None else [bf(a) for a in cp])


def _run(mod, kind, x, c, params, cpe, img_w, **kw):
    n, m = x.shape[1], c.shape[1]
    cw = {} if cpe is None else dict(cpe=cpe, img_w=img_w)
    if kind == "s":
        return mod(x, c, params, num_heads=H, **cw, **kw)
    sx, sc = dca_scales(n, m, C)
    return mod(x, c, params, num_heads=H, scale_x=sx, scale_c=sc, **cw,
               **kw)


def _check(kind, n, m, dtype, cpe=False, d2=False, img_w=8):
    key = (kind, n, m, cpe, d2)
    x, c, params, cp = _case(*key)
    if key not in _JAX:
        jfn = pallas_block.s_block if kind == "s" else pallas_block.dca_block
        jp = tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)
        jc = None if cp is None else tuple(map(jnp.asarray, cp))
        out = _run(jfn, kind, jnp.asarray(x), jnp.asarray(c), jp, jc, img_w)
        assert out is not None, "the JAX package declines this case"
        _JAX[key] = [np.asarray(o) for o in out]
    to = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    tfn = fb.s_block_tiles_plain if kind == "s" else fb.dca_block_tiles_plain
    got = _run(tfn, kind, to(x), to(c), [to(a) for a in params],
               None if cp is None else [to(a) for a in cp], img_w)
    for g, w in zip(got, _JAX[key]):
        assert g.dtype == dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m", [(49, 16), (64, 16), (200, 16), (64, 32),
                                 (64, 128)],
                         ids=["n49", "n64", "n200-ragged", "m32", "m128"])
def test_s_block_tiles_matches_jax(n, m, dtype):
    _check("s", n, m, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m", [(64, 16), (200, 16), (64, 32), (64, 128)],
                         ids=["n64", "n200-ragged", "m32", "m128"])
def test_dca_block_tiles_matches_jax(n, m, dtype):
    """N = 49 is not taken by the JAX D kernel (no N tile); N = 200 leaves
    ragged image-row tiles of the DCA attention in both types."""
    _check("d", n, m, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_dca_block_tiles_d2_matches_jax(dtype):
    """D2 through the weight permutation: q1 = k1, q2 = k2."""
    _check("d", 64, 16, dtype, d2=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["s", "d"])
def test_block_tiles_cpe_matches_jax(kind, dtype):
    """The cpe form: x before its 3x3 CPE, 8x8 images."""
    _check(kind, 64, 16, dtype, cpe=True)


def test_cpu_tiles_models_are_the_plain_blocks_in_fp32():
    """In fp32 the tile models round nowhere: they are the plain
    compositions up to the order of fp32 sums."""
    x, c, params, _ = _case("s", 64, 16, False)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    ps = [t(a) for a in params]
    for got, want in zip(fb.s_block_tiles_plain(t(x), t(c), ps, num_heads=H),
                         fb.s_block_plain(t(x), t(c), ps, num_heads=H)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
