"""PyTorch port, the attention-only kernels' order of work on the CPU:
attn/mhsa.py::mhsa_tiles_plain (csrc/mhsa.cu: an online softmax in
32-key steps, in exp2 with the scale folded in, P rounded to the input
type before P v) and attn/dca.py::dca_tiles_plain (csrc/dca_attn.cu: the x
direction's softmax over the meta keys, its maxima and sums taken over
key tiles of 16; the c direction's partial softmax per 16 image keys and
16 meta queries, merged per tile of image rows, then the tiles merged in a
fixed order), held against the JAX package's pallas_mhsa.mhsa
and pallas_dca.dca in interpret mode (as tests/test_torch_seg_attn.py runs
them) on the same numpy-seeded inputs. Where pallas_dca declines N (no N
tile: N = 1000), against pallas_dca._xla_dca, the JAX composition the
modules fall back to. fp32 inputs at rtol = atol = 1e-5; bf16 inputs (the
same numbers handed to JAX in fp32) at 2e-2 against JAX's fp32 result.
Also dca at 32 and 128 meta tokens (two and eight tiles of 16) and the
workspace that attn/dca.py sizes from the tile. The CUDA kernels
are held against these models on the card in tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_dca, pallas_mhsa
from lemevit_tpu_torch.attn import dca as tdca
from lemevit_tpu_torch.attn import mhsa as tmhsa
from lemevit_tpu_torch.attn.reference import dca_scales

H, D = 2, 32
C = H * D
M = 16
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_dca, "_INTERPRET", True)
    monkeypatch.setattr(pallas_mhsa, "_INTERPRET", True)


def _inputs(seed, lengths, b, dtype):
    """(torch tensors in dtype, the same numbers as fp32 numpy arrays)."""
    rng = np.random.RandomState(seed)
    ts = [torch.from_numpy(rng.randn(b, n, C).astype(np.float32)).to(dtype)
          for n in lengths]
    return ts, [t.float().numpy() for t in ts]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,b", [(16, 2), (200, 2), (1024, 1)],
                         ids=["n16", "n200-ragged", "n1024"])
def test_mhsa_tiles_matches_jax(n, b, dtype):
    ts, arrs = _inputs(n + 1, (n, n, n), b, dtype)
    want = pallas_mhsa.mhsa(*map(jnp.asarray, arrs), num_heads=H)
    got = tmhsa.mhsa_tiles_plain(*ts, scale=D ** -0.5, num_heads=H)
    assert got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m", [(256, M), (1000, M), (4096, M), (256, 32),
                                 (1000, 128)],
                         ids=["n256", "n1000-ragged", "n4096", "n256-m32",
                              "n1000-m128"])
def test_dca_tiles_matches_jax(n, m, dtype):
    """N = 1000 leaves a ragged last tile of image rows in both types (64
    rows a tile in fp32, 128 in bf16); N = 4096 is UperNet stage 2's
    length; M = 32 and 128 take two and eight meta tiles of 16 (128 is
    LeMeViT's default queries_len)."""
    b = 2 if n < 4096 else 1
    ts, arrs = _inputs(n + m, (n, n, n, m, m, m), b, dtype)
    sx, sc = dca_scales(n, m, C)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=H)
    jargs = list(map(jnp.asarray, arrs))
    want = pallas_dca.dca(*jargs, **kw)
    if tdca.pick_tile(n) == 0:
        assert want is None  # pallas_dca declines: JAX composes
        want = pallas_dca._xla_dca(*jargs, sx, sc, H)
    got = tdca.dca_tiles_plain(*ts, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_dca_tiles_aliased_d2_matches_jax(dtype):
    """D2's dca(q, q, v1, k, k, v2): one tensor as q1 and k1, one as q2 and
    k2."""
    (q, v1, k, v2), arrs = _inputs(9, (256, 256, M, M), 2, dtype)
    sx, sc = dca_scales(256, M, C)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=H)
    jq, jv1, jk, jv2 = map(jnp.asarray, arrs)
    want = pallas_dca.dca(jq, jq, jv1, jk, jk, jv2, **kw)
    got = tdca.dca_tiles_plain(q, q, v1, k, k, v2, **kw)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("n,tile,tiles", [(16384, 128, 128), (4096, 64, 64),
                                          (1000, 128, 8), (1000, 64, 16)])
def test_dca_workspace_is_sized_from_the_tile(n, tile, tiles):
    """One row per (image, head, tile, meta query): its max, its sum and
    its 32 channel sums, as one fp32 tensor."""
    b, h = 8, 4
    assert tdca.n_tiles(n, tile) == tiles
    rows = tdca.workspace_rows(b, h, M, n, tile)
    assert rows == b * h * tiles * M
    work = tdca.workspace(b, h, M, n, tile, "cpu")
    assert work.dtype == torch.float32
    assert work.numel() == rows * (2 + D)
