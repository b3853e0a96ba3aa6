"""PyTorch port, the S stage in one launch and the in-kernel CPE: the plain
versions behind ``fused_block.s_stage`` and the blocks' ``cpe`` modes
against the JAX package's fused Pallas kernels (interpret mode on the CPU,
as tests/test_pallas.py runs them), ``stage_takes`` against the JAX
declines, ``LeMeBlock.cpe_weights`` against JAX's taps, and a model on the
slice's path (``s_stage=True, cpe_in_kernel=True``, kernel path forced on
the CPU) against the JAX model. fp32; blocks and stages 3e-5 (the JAX
suite's tolerance for fused blocks), the model 2e-4 (tests/
test_torch_parity.py's). The CUDA kernels are held against these plain
versions on the card in tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.models import LeMeViT as JLeMeViT
from lemevit_tpu.models.lemevit import LeMeBlock as JBlock
from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import dca_scales
from lemevit_tpu_torch.models import LeMeViT as TLeMeViT
from lemevit_tpu_torch.models import lemevit as tlemevit
from lemevit_tpu_torch.models.convert import from_jax_params
from lemevit_tpu_torch.models.lemevit import LeMeBlock as TBlock

C, H, M = 64, 2, 16
TOL = dict(rtol=3e-5, atol=3e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# lemevit_micro's widths with S stages of depth 2 and 16 meta tokens (the
# JAX kernels decline micro's 4 on M % 8)
MICRO_S2 = dict(depth=(1, 1, 1, 2, 2), embed_dim=(16, 16, 32, 32, 32),
                head_dim=8, mlp_ratios=(2, 2, 2, 2, 2),
                attn_type=("C", "D", "D", "S", "S"), queries_len=16,
                num_classes=7)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def _ln(rng, ch=C):
    return [1 + 0.1 * rng.randn(ch), 0.1 * rng.randn(ch)]


def _lin(rng, out, inp):
    return [rng.randn(out, inp) / np.sqrt(inp), 0.1 * rng.randn(out)]


def make_params(kind, rng, ch=C, hidden=2 * C):
    """Parameter tuple of fused_block (torch layout), float32 numpy."""
    if kind == "c":
        p = (_ln(rng, ch) + _lin(rng, ch, ch) + _lin(rng, 2 * ch, ch)
             + _lin(rng, ch, ch))
    elif kind == "d":
        p = (_ln(rng, ch) + _lin(rng, 3 * ch, ch) + _lin(rng, 3 * ch, ch)
             + _lin(rng, ch, ch) + _lin(rng, ch, ch))
    else:
        p = _ln(rng, ch) + _lin(rng, 3 * ch, ch) + _lin(rng, ch, ch)
    p += _ln(rng, ch) + _lin(rng, hidden, ch) + _lin(rng, ch, hidden)
    return [a.astype(np.float32) for a in p]


def make_cpe(rng, ch=C):
    """(taps (9, C) in (ky, kx) order, bias (C,)), float32 numpy."""
    return [(0.3 * rng.randn(9, ch)).astype(np.float32),
            (0.1 * rng.randn(ch)).astype(np.float32)]


def _jax_layout(params):
    """torch Linear (out, in) -> the Pallas kernels' (in, out)."""
    return tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("use_cpe", [False, True], ids=["no_cpe", "cpe"])
def test_s_stage_plain_matches_pallas_stage(interpret, use_cpe):
    """fused_block.s_stage on CPU tensors (s_stage_plain) against
    pallas_block.s_stage: B = 4, an 8x8 image, 3 blocks."""
    rng = np.random.RandomState(21 + use_cpe)
    b, img_h, img_w, nb = 4, 8, 8, 3
    x = rng.randn(b, img_h * img_w, C).astype(np.float32)
    c = rng.randn(b, M, C).astype(np.float32)
    params = [make_params("s", rng) for _ in range(nb)]
    cpes = [make_cpe(rng) for _ in range(nb)] if use_cpe else None
    want = pallas_block.s_stage(
        jnp.asarray(x), jnp.asarray(c), [_jax_layout(p) for p in params],
        num_heads=H, img_w=img_w,
        cpes=None if cpes is None else [tuple(map(jnp.asarray, cp))
                                        for cp in cpes])
    assert want is not None
    before = dict(fb.LAUNCHES)
    with torch.no_grad():
        got = fb.s_stage(torch.from_numpy(x), torch.from_numpy(c),
                         [_t(p) for p in params], num_heads=H, img_w=img_w,
                         cpes=None if cpes is None else [_t(cp)
                                                         for cp in cpes])
    assert fb.LAUNCHES == before  # CPU tensors: the plain version
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


def _block(kind, mod, x, c, params, n, **kw):
    if kind == "c":
        return (mod.c_block(x, c, params, num_heads=H, **kw),)
    if kind == "d":
        sx, sc = dca_scales(n, M, C)
        return mod.dca_block(x, c, params, num_heads=H, scale_x=sx,
                             scale_c=sc, **kw)
    return mod.s_block(x, c, params, num_heads=H, **kw)


@pytest.mark.parametrize("kind", ["c", "d", "s"])
def test_block_cpe_matches_pallas_block(interpret, kind):
    """Each block's plain version with cpe / img_w against the Pallas block
    with its in-kernel CPE, on a non-square 8 x 4 image (H != W, so a swap
    of the two shows)."""
    rng = np.random.RandomState(30 + ord(kind))
    img_h, img_w = 8, 4
    n = img_h * img_w
    x = rng.randn(2, n, C).astype(np.float32)
    c = rng.randn(2, M, C).astype(np.float32)
    params = make_params(kind, rng)
    cpe = make_cpe(rng)
    want = _block(kind, pallas_block, jnp.asarray(x), jnp.asarray(c),
                  _jax_layout(params), n,
                  cpe=tuple(map(jnp.asarray, cpe)), img_w=img_w)
    assert want is not None and want[0] is not None
    with torch.no_grad():
        got = _block(kind, fb, torch.from_numpy(x), torch.from_numpy(c),
                     _t(params), n, cpe=_t(cpe), img_w=img_w)
        # ... and it is the block after an external CPE of the same taps
        xt = fb.cpe_plain(torch.from_numpy(x), *_t(cpe), img_w)
        ext = _block(kind, fb, xt, torch.from_numpy(c), _t(params), n)
    assert len(got) == len(want)
    for g_, w_, e_ in zip(got, want, ext):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)
        assert torch.equal(g_, e_)


def test_cpe_plain_is_the_blocks_dwconv():
    """cpe_plain with cpe_weights() is the block's own CPE (DWConv on the
    NHWC map), on a non-square image."""
    torch.manual_seed(0)
    blk = TBlock(C, H, "S")
    x = torch.randn(2, 8, 4, C)
    taps, bias = blk.cpe_weights()
    with torch.no_grad():
        got = fb.cpe_plain(x.reshape(2, 32, C), taps, bias, 4)
        want = blk._cpe(x).reshape(2, 32, C)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert taps.shape == (9, C) and taps.is_contiguous()


@pytest.mark.parametrize("nb,n,m,ch,heads,mixed", [
    (1, 64, 16, 64, 2, False),     # fewer than 2 blocks
    (2, 1025, 16, 64, 2, False),   # N above 1024
    (2, 64, 16, 64, 3, False),     # C not divisible by the heads
    (2, 64, 12, 64, 2, False),     # M % 8
    (2, 64, 16, 64, 2, True),      # some blocks with a CPE, some without
    (2, 16, 8, 64, 2, False),      # taken
], ids=["one_block", "n1025", "heads", "m12", "mixed_cpe", "taken"])
def test_stage_takes_mirrors_jax_declines(interpret, nb, n, m, ch, heads,
                                          mixed):
    rng = np.random.RandomState(5)
    params = [_jax_layout(make_params("s", rng, ch)) for _ in range(nb)]
    cpes = ([tuple(map(jnp.asarray, make_cpe(rng, ch))), None]
            if mixed else None)
    x = jnp.asarray(rng.randn(1, n, ch).astype(np.float32))
    c = jnp.asarray(rng.randn(1, m, ch).astype(np.float32))
    jax_takes = pallas_block.s_stage(x, c, params, num_heads=heads,
                                     cpes=cpes, img_w=4) is not None
    assert fb.stage_takes(n, m, ch, heads, nb, cpes) == jax_takes


def test_cpe_weights_match_jax_taps():
    """The (ky, kx) order: LeMeBlock.cpe_weights() on weights moved from
    the JAX block equals JAX's _cpe_weights."""
    from tests.test_torch_port_blocks import _randomize, block_state_dict
    rng = np.random.RandomState(9)
    x = jnp.asarray(rng.randn(1, 8, 4, C).astype(np.float32))
    c = jnp.asarray(rng.randn(1, M, C).astype(np.float32))
    jb = JBlock(dim=C, num_heads=H, attn_type="S", attn_backend="xla")
    v = {"params": _randomize(jb.init(jax.random.PRNGKey(0), x, c)["params"],
                              rng)}
    want = jb._cpe_weights(v["params"])
    tb = TBlock(C, H, "S")
    tb.load_state_dict(block_state_dict(v["params"]), strict=True)
    got = tb.cpe_weights()
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.detach().numpy(), np.asarray(w_))
    assert TBlock(C, H, "S", cpe_ks=0).cpe_weights() is None
    with pytest.raises(LookupError):
        TBlock(C, H, "S", cpe_ks=5).cpe_weights()


def _spy(monkeypatch, name, calls):
    real = getattr(fb, name)

    def spy(*args, **kw):
        calls.append((name, kw.get("cpe", kw.get("cpes"))))
        return real(*args, **kw)
    monkeypatch.setattr(fb, name, spy)


def test_model_slice_path_matches_jax(monkeypatch):
    """A micro model with S stages of depth 2 on the slice's path (s_stage,
    cpe_in_kernel; the kernel path forced on the CPU) against the JAX
    model (xla) on the same weights, on a non-square 64 x 96 image: one
    s_stage call per S stage, no s_block, and every C / D block given its
    CPE."""
    from tests.test_torch_port_model import _randomize
    jm = JLeMeViT(**MICRO_S2, attn_backend="xla")
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    rng = np.random.RandomState(0)
    v = {"params": _randomize(v["params"], rng),
         "batch_stats": _randomize(v["batch_stats"], rng, True)}
    img = np.random.RandomState(1).rand(2, 64, 96, 3).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, v),
                                        jnp.asarray(img)))

    tm = TLeMeViT(**MICRO_S2, s_stage=True, cpe_in_kernel=True).eval()
    tm.load_state_dict(from_jax_params(v, tm), strict=True)
    monkeypatch.setattr(tlemevit, "use_kernel", lambda backend, t: True)
    calls = []
    for name in ("c_block", "dca_block", "s_block", "s_stage"):
        _spy(monkeypatch, name, calls)
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    assert [n for n, _ in calls] == ["c_block", "dca_block", "dca_block",
                                     "s_stage", "s_stage"]
    assert all(cp is not None and len(cp) == 2 for _, cp in calls)


def test_model_slice_path_only_in_inference(monkeypatch):
    """s_stage runs in eval mode without autograd, never in training or
    under attn_backend "torch"; without cpe_in_kernel the blocks get no
    CPE (it runs outside)."""
    torch.manual_seed(0)
    tm = TLeMeViT(**MICRO_S2, s_stage=True).eval()
    monkeypatch.setattr(tlemevit, "use_kernel",
                        lambda backend, t: backend != "torch")
    calls = []
    for name in ("c_block", "dca_block", "s_block", "s_stage"):
        _spy(monkeypatch, name, calls)
    x = torch.randn(2, 64, 64, 3)
    with torch.no_grad():
        tm(x)
    assert [n for n, _ in calls].count("s_stage") == 2
    assert [cp for n, cp in calls if n != "s_stage"] == [None] * 3
    calls.clear()
    with torch.no_grad():
        tm.set_attn_backend("torch")
        tm(x)
        tm.set_attn_backend("auto")
    tm(x)  # eval mode, autograd on: the composition
    assert calls == []


def test_entry_points_match_their_ctypes_signatures():
    """Every ``extern "C" int lm_*`` of csrc/*.cu has the argument types
    that _build.SIGNATURES gives ctypes (no nvcc here: a mismatch would
    show only as a wrong call on the card)."""
    import ctypes
    import re
    from lemevit_tpu_torch.attn import _build
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "void*": ctypes.c_void_p,
             "const void* const*": ctypes.POINTER(ctypes.c_void_p)}
    found = {}
    for src in _build.sources():
        for name, args in re.findall(r'extern "C" int (lm_\w+)\(([^)]*)\)',
                                     src.read_text()):
            found[name] = [kinds[" ".join(a.split()[:-1])]
                           for a in args.split(",")]
    assert found == _build.SIGNATURES
