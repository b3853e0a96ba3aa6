"""PyTorch port, whole-block kernels: each ``*_plain`` version against the
JAX package's fused Pallas block (run in interpret mode on the CPU, as
tests/test_pallas.py runs it), the port's LeMeBlock against the JAX
LeMeBlock, and the D2 weight permutation. fp32, tolerance 3e-5 (the JAX
suite's own for fused blocks). The CUDA kernels are held against these
plain versions on the card in tests/test_torch_gpu.py."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.models.lemevit import LeMeBlock as JBlock
from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import dca_scales
from lemevit_tpu_torch.models.lemevit import LeMeBlock as TBlock

C, H, M = 64, 2, 16
TOL = dict(rtol=3e-5, atol=3e-5)
PLAIN = SimpleNamespace(c_block=fb.c_block_plain,
                        dca_block=fb.dca_block_plain,
                        s_block=fb.s_block_plain)


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


def _jax_layout(params):
    """torch Linear (out, in) -> the Pallas kernels' (in, out)."""
    return tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)


def _run(kind, mod, x, c, params, n):
    if kind == "c":
        return (mod.c_block(x, c, params, num_heads=H),)
    if kind == "d":
        sx, sc = dca_scales(n, M, C)
        return mod.dca_block(x, c, params, num_heads=H, scale_x=sx,
                             scale_c=sc)
    return mod.s_block(x, c, params, num_heads=H)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("kind", ["c", "d", "s"])
def test_plain_matches_pallas_block(interpret, kind, n):
    rng = np.random.RandomState(n + ord(kind))
    x = rng.randn(2, n, C).astype(np.float32)
    c = rng.randn(2, M, C).astype(np.float32)
    params = make_params(kind, rng)
    want = _run(kind, pallas_block, jnp.asarray(x), jnp.asarray(c),
                _jax_layout(params), n)
    with torch.no_grad():
        got = _run(kind, fb, torch.from_numpy(x), torch.from_numpy(c),
                   [torch.from_numpy(a) for a in params], n)
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 64, C).astype(np.float32))
    c = torch.from_numpy(rng.randn(2, M, C).astype(np.float32))
    before = dict(fb.LAUNCHES)
    for kind in "cds":
        params = [torch.from_numpy(a) for a in make_params(kind, rng)]
        got = _run(kind, fb, x, c, params, 64)
        want = _run(kind, PLAIN, x, c, params, 64)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
    assert fb.LAUNCHES == before


# ---------------------------------------------------------------- blocks


def _randomize(tree, rng):
    """Replace JAX init values with O(1)-scale ones of the same shapes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = jnp.asarray(rng.randn(*v.shape) / np.sqrt(fan_in),
                                 jnp.float32)
        elif k == "scale":
            out[k] = jnp.asarray(1 + 0.1 * rng.randn(*v.shape), jnp.float32)
        else:
            out[k] = jnp.asarray(0.1 * rng.randn(*v.shape), jnp.float32)
    return out


def block_state_dict(p):
    """JAX LeMeBlock params -> the port's block state_dict."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd = {"pos_embed.weight": t(np.transpose(
              np.asarray(p["pos_embed"]["dwconv"]["kernel"]), (3, 2, 0, 1))),
          "pos_embed.bias": t(p["pos_embed"]["dwconv"]["bias"])}
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"] = t(p[n]["scale"])
        sd[f"{n}.bias"] = t(p[n]["bias"])
    for name, tree in p["attn"].items():
        sd[f"attn.{name}.weight"] = t(np.asarray(tree["kernel"]).T)
        sd[f"attn.{name}.bias"] = t(tree["bias"])
    for jn, tn in (("fc1", "0"), ("fc2", "3")):
        sd[f"mlp.{tn}.weight"] = t(np.asarray(p["mlp"][jn]["kernel"]).T)
        sd[f"mlp.{tn}.bias"] = t(p["mlp"][jn]["bias"])
    for g in ("gamma1", "gamma2"):
        if g in p:
            sd[g] = t(np.asarray(p[g]).reshape(-1))
    return sd


@pytest.mark.parametrize("attn_type", ["C", "D", "D2", "S"])
def test_block_matches_jax_and_fused_params(attn_type):
    """Port LeMeBlock (composition) vs JAX LeMeBlock (xla); then the fused
    route on the CPU (CPE outside, fused_params -> *_plain, D2 through the
    weight permutation) vs the composition."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, C).astype(np.float32)
    c = rng.randn(2, M, C).astype(np.float32)
    jb = JBlock(dim=C, num_heads=H, attn_type=attn_type, mlp_ratio=2.0,
                attn_backend="xla")
    v = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(c))
    v = {"params": _randomize(v["params"], rng)}
    jx, jc = jb.apply(v, jnp.asarray(x), jnp.asarray(c))

    tb = TBlock(C, H, attn_type, mlp_ratio=2.0, attn_backend="torch").eval()
    tb.load_state_dict(block_state_dict(v["params"]), strict=True)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    with torch.no_grad():
        tx, tc = tb(xt, ct)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        if attn_type == "C":
            assert torch.equal(tx, xt)  # x passes through, pre-CPE

        tokens = tb._cpe(xt).reshape(2, 64, C)
        params = tb.fused_params()
        if attn_type == "C":
            fc = fb.c_block(tokens, ct, params, num_heads=H)
            fx = tx.reshape(2, 64, C)
        elif attn_type == "S":
            fx, fc = fb.s_block(tokens, ct, params, num_heads=H)
        else:
            sx, sc = dca_scales(64, M, C)
            fx, fc = fb.dca_block(tokens, ct, params, num_heads=H,
                                  scale_x=sx, scale_c=sc)
    np.testing.assert_allclose(fx.reshape(2, 8, 8, C).numpy(), tx.numpy(),
                               **TOL)
    np.testing.assert_allclose(fc.numpy(), tc.numpy(), **TOL)


@pytest.mark.parametrize("variant", [dict(layer_scale_init_value=0.5),
                                     dict(pre_norm=False)],
                         ids=["layer_scale", "post_norm"])
@pytest.mark.parametrize("attn_type", ["C", "D", "D2", "S"])
def test_block_composition_variants_match_jax(attn_type, variant):
    """Layer-scale and post-norm blocks (never fused) against JAX."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 8, C).astype(np.float32)
    c = rng.randn(2, M, C).astype(np.float32)
    jb = JBlock(dim=C, num_heads=H, attn_type=attn_type, attn_backend="xla",
                **variant)
    v = jb.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(c))
    v = {"params": _randomize(v["params"], rng)}
    jx, jc = jb.apply(v, jnp.asarray(x), jnp.asarray(c))
    tb = TBlock(C, H, attn_type, **variant).eval()
    tb.load_state_dict(block_state_dict(v["params"]), strict=True)
    with torch.no_grad():
        assert not tb._fusable(torch.from_numpy(x), torch.from_numpy(c))
        tx, tc = tb(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_d2_permutation_layout():
    """[Wq|Wq|Wv1] / [Wk|Wk|Wv2]: q1 = k1 = q, q2 = k2 = k."""
    tb = TBlock(C, H, "D2")
    p = tb.fused_params()
    wqkv1, wqkv2 = p[2], p[4]
    wq, wv1 = tb.attn.qv1.weight[:C], tb.attn.qv1.weight[C:]
    wk, wv2 = tb.attn.kv2.weight[:C], tb.attn.kv2.weight[C:]
    assert torch.equal(wqkv1, torch.cat([wq, wq, wv1]))
    assert torch.equal(wqkv2, torch.cat([wk, wk, wv2]))
    assert p[3].shape == (3 * C,) and p[5].shape == (3 * C,)
