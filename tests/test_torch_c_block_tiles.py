"""PyTorch port, the C block kernel's order of work on the CPU:
attn/fused_block.py::c_block_tiles_plain (csrc/c_block.cu on
block_tc.cuh's k_qkv_wg with two streams of different widths, kv from the
image rows and q from the meta rows, attn_tc.cuh's c-direction instance
of k_dca_tc + k_dca_merge and k_tail_wg on the meta rows: LN1, kv and q
rounded to the input type, per-warp partial softmaxes over 16 image keys
with P rounded before P v, merged per tile and the tiles merged in a fixed
order, LN2 rounded, each 128-wide hidden chunk rounded after its GELU,
fp32 sums), held against the JAX package's fused Pallas C block
pallas_block.c_block in interpret mode and against the fp32 plain version
c_block_plain, on numpy-seeded inputs: C = 64 with 2 heads, (N, M) = (64,
16), a ragged (200, 16) (past the 128- / 64-row attention tiles) and (64,
32) (two meta tiles), and the cpe form (x before its 3x3 CPE, 8 x 8
images).

Tolerances: fp32 at 2e-4; bf16 (every input rounded to bf16 first, so JAX
sees the same numbers in fp32) at 3e-2 (max|ref| + |ref|) against JAX's
fp32 result, as tests/test_torch_train_fwd_tiles.py holds its tile model.
The CUDA kernel is held against this model on the card in
tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu_torch.attn import fused_block as fb
from tests.test_torch_train_tiles import C, DTYPES, H, _bf16, _check, _t

IMG_W = 8
NAMES = ["c_out"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _case(n, m, cpe, seed):
    """x, c, the C block's params (torch layout) and the CPE pair (or
    None), bf16-rounded fp32 numpy."""
    rng = np.random.RandomState(seed)
    lin = lambda o, i: [_bf16(rng.randn(o, i) / np.sqrt(i)),  # noqa: E731
                        _bf16(0.1 * rng.randn(o))]
    ln = lambda: [_bf16(1 + 0.1 * rng.randn(C)),  # noqa: E731
                  _bf16(0.1 * rng.randn(C))]
    x, c = _bf16(rng.randn(2, n, C)), _bf16(rng.randn(2, m, C))
    params = (ln() + lin(C, C) + lin(2 * C, C) + lin(C, C) + ln()
              + lin(4 * C, C) + lin(C, 4 * C))
    taps = [_bf16(0.3 * rng.randn(9, C)), _bf16(0.1 * rng.randn(C))] \
        if cpe else None
    return x, c, params, taps


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m,cpe", [(64, 16, False), (200, 16, False),
                                     (64, 32, False), (64, 16, True)],
                         ids=["n64", "n200-ragged", "m32", "cpe"])
def test_c_block_tiles_match_jax_and_plain(n, m, cpe, dtype):
    """c_block_tiles_plain against JAX's pallas_block.c_block and the fp32
    c_block_plain on the same inputs."""
    x, c, params, taps = _case(n, m, cpe, 81 + n + m + 7 * cpe)
    kw = {"num_heads": H}
    if cpe:
        kw["img_w"] = IMG_W
    jp = tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)
    jc = None if taps is None else tuple(map(jnp.asarray, taps))
    want = pallas_block.c_block(jnp.asarray(x), jnp.asarray(c), jp, cpe=jc,
                                **kw)
    assert want is not None, "the JAX package declines this case"

    def run(fn, dt):
        cp = None if taps is None else [_t(a, dt) for a in taps]
        return fn(_t(x, dt), _t(c, dt), [_t(a, dt) for a in params], cpe=cp,
                  **kw)

    got = run(fb.c_block_tiles_plain, dtype)
    assert got.dtype == dtype and got.shape == c.shape
    _check([got], [np.asarray(want)], dtype, NAMES, 1)
    _check([got], [run(fb.c_block_plain, torch.float32).numpy()], dtype,
           NAMES, 1)
