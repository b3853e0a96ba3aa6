"""PyTorch port, core layers, reference attention and attention modules
against the JAX package on the CPU (fp32, atol 1e-5).

The same numpy-seeded inputs and the same weights (JAX init, moved across
as numpy) go through lemevit_tpu and lemevit_tpu_torch."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import modules as jmod
from lemevit_tpu.attn import reference as jref
from lemevit_tpu.core import layers as jl
from lemevit_tpu_torch.attn import modules as tmod
from lemevit_tpu_torch.attn import reference as tref
from lemevit_tpu_torch.core import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin_sd(tree, dst):
    return {f"{dst}.weight": _t(_np(tree["kernel"]).T),
            f"{dst}.bias": _t(tree["bias"])}


def _conv_sd(tree, dst):
    return {f"{dst}.weight": _t(np.transpose(_np(tree["kernel"]),
                                             (3, 2, 0, 1))),
            f"{dst}.bias": _t(tree["bias"])}


def _bn_vars(variables, rng):
    """Random running statistics, so the BN mapping is exercised."""
    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "mean":
                out[k] = jnp.asarray(rng.randn(*v.shape), jnp.float32)
            else:
                out[k] = jnp.asarray(rng.rand(*v.shape) + 0.5, jnp.float32)
        return out
    return {"params": variables["params"],
            "batch_stats": perturb(variables["batch_stats"])}


def _bn_sd(params, stats, dst):
    return {f"{dst}.weight": _t(params["scale"]),
            f"{dst}.bias": _t(params["bias"]),
            f"{dst}.running_mean": _t(stats["mean"]),
            f"{dst}.running_var": _t(stats["var"]),
            f"{dst}.num_batches_tracked": torch.tensor(0)}


def test_conv_stem_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    jm = jl.ConvStem(16)
    v = _bn_vars(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    p, s = v["params"], v["batch_stats"]
    tm = tl.ConvStem(3, 16).eval()
    sd = {**_conv_sd(p["conv1"]["conv"], "0"),
          **_bn_sd(p["conv1"]["bn"], s["conv1"]["bn"], "1"),
          **_conv_sd(p["conv2"]["conv"], "3"),
          **_bn_sd(p["conv2"]["bn"], s["conv2"]["bn"], "4")}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jm.apply(v, jnp.asarray(x))), **TOL)


def test_conv_bn_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    jm = jl.ConvBN(32)
    v = _bn_vars(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    tm = tl.ConvBN(16, 32).eval()
    tm.load_state_dict({**_conv_sd(v["params"]["conv"], "0"),
                        **_bn_sd(v["params"]["bn"], v["batch_stats"]["bn"],
                                 "1")}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jm.apply(v, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("tokens", [False, True])
def test_dwconv_matches_jax(tokens):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    jm = jl.DWConv(8)
    xin = x.reshape(2, 30, 8) if tokens else x
    hw = (6, 5) if tokens else None
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(xin), hw)
    tm = tl.DWConv(8)
    sd = _conv_sd(v["params"]["dwconv"], "conv")
    tm.load_state_dict({k[len("conv."):]: t for k, t in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(xin), hw).numpy()
    np.testing.assert_allclose(got, _np(jm.apply(v, jnp.asarray(xin), hw)),
                               **TOL)


def test_mlp_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 16).astype(np.float32) * 3
    jm = jl.Mlp(16, 64)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tm = tl.Mlp(16, 64)
    tm.load_state_dict({**_lin_sd(v["params"]["fc1"], "0"),
                        **_lin_sd(v["params"]["fc2"], "3")}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jm.apply(v, jnp.asarray(x))), **TOL)


def test_meta_token_downsample_matches_jax():
    rng = np.random.RandomState(4)
    c = rng.randn(2, 16, 16).astype(np.float32)
    jm = jl.MetaTokenDownsample(16, 32)
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(c))
    p = v["params"]
    ln = lambda tree, dst: {f"{dst}.weight": _t(tree["scale"]),
                            f"{dst}.bias": _t(tree["bias"])}
    tm = tl.MetaTokenDownsample(16, 32)
    tm.load_state_dict({**_lin_sd(p["fc1"], "0"), **ln(p["ln1"], "1"),
                        **_lin_sd(p["fc2"], "3"), **ln(p["ln2"], "4")},
                       strict=True)
    assert tm[1].eps == 1e-5 and tm[4].eps == 1e-5
    with torch.no_grad():
        got = tm(torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, _np(jm.apply(v, jnp.asarray(c))), **TOL)


def test_drop_path():
    x = torch.randn(64, 3, 5)
    dp = tl.DropPath(0.5)
    dp.eval()
    assert torch.equal(dp(x), x)
    dp.train()
    dp.generator = torch.Generator().manual_seed(0)
    y = dp(x)
    kept = (y == 0).flatten(1).all(1) | torch.isclose(y, x * 2).flatten(
        1).all(1)
    assert kept.all()
    assert 0 < (y == 0).flatten(1).all(1).sum() < 64
    assert torch.equal(tl.DropPath(0.0).train()(x), x)


def test_init_distributions():
    g = torch.Generator().manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(64, 256),
                            torch.nn.Conv2d(8, 16, 3),
                            torch.nn.LayerNorm(16))
    tl.init_weights(m, g)
    w = m[0].weight
    assert w.abs().max() <= 0.04 + 1e-7 and abs(w.std().item() - 0.0176) < 3e-3
    assert torch.count_nonzero(m[0].bias) == 0
    bound = 1 / math.sqrt(8 * 9)
    assert m[1].weight.abs().max() <= bound and m[1].bias.abs().max() <= bound
    assert torch.equal(m[2].weight, torch.ones(16))
    # same seed, same weights
    m2 = torch.nn.Sequential(torch.nn.Linear(64, 256))
    tl.init_weights(m2, torch.Generator().manual_seed(0))
    assert torch.equal(m2[0].weight, w)


# ---------------------------------------------------------------- attention


def test_dca_scales_match_jax():
    for n, m, c in [(3136, 16, 96), (784, 16, 192), (64, 16, 64)]:
        assert tref.dca_scales(n, m, c) == pytest.approx(
            jref.dca_scales(n, m, c), rel=1e-12)
    # full embed dim, not head_dim
    assert tref.dca_scales(3136, 16, 96)[1] == pytest.approx(96 ** -0.5)


@pytest.mark.parametrize("nq,nk,scale", [(37, 37, None), (16, 200, 0.3),
                                         (200, 16, 0.05)])
def test_sdpa_bnhd_matches_jax(nq, nk, scale):
    rng = np.random.RandomState(nq + nk)
    q, k, v = (rng.randn(2, n, 3, 16).astype(np.float32)
               for n in (nq, nk, nk))
    got = tref.sdpa_bnhd(*map(torch.from_numpy, (q, k, v)), scale=scale)
    want = jref.sdpa_bnhd(*map(jnp.asarray, (q, k, v)), scale=scale)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_sdpa_chunked_matches_one_shot():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 200, 3, 16).astype(np.float32))
               for _ in range(3))
    got = tref.sdpa_bnhd_chunked(q, k, v, target_bytes=2 * 3 * 200 * 4 * 64)
    np.testing.assert_allclose(got.numpy(), tref.sdpa_bnhd(q, k, v).numpy(),
                               **TOL)


_MODULES = {
    "S": (jmod.StandardAttention, tmod.StandardAttention, ["qkv", "proj"]),
    "C": (jmod.CrossAttention, tmod.CrossAttention, ["q", "kv", "proj"]),
    "D": (jmod.DualCrossAttention, tmod.DualCrossAttention,
          ["qkv1", "qkv2", "proj_x", "proj_c"]),
    "D2": (jmod.DualCrossAttentionV2, tmod.DualCrossAttentionV2,
           ["qv1", "kv2", "proj_x", "proj_c"]),
}


@pytest.mark.parametrize("kind", ["S", "C", "D", "D2"])
def test_attention_module_matches_jax(kind):
    jcls, tcls, names = _MODULES[kind]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 64, 32).astype(np.float32)
    c = rng.randn(2, 16, 32).astype(np.float32)
    jm = jcls(dim=32, num_heads=4, backend="xla")
    args = (jnp.asarray(x),) if kind == "S" else (jnp.asarray(x),
                                                  jnp.asarray(c))
    v = jm.init(jax.random.PRNGKey(5), *args)
    # trunc-normal(0.02) weights barely move the softmax: scale them up
    v = jax.tree.map(lambda a: a * 20.0, v)
    tm = tcls(32, 4)
    sd = {}
    for name in names:
        sd.update(_lin_sd(v["params"][name], name))
    tm.load_state_dict(sd, strict=True)
    targs = [torch.from_numpy(x)] + ([] if kind == "S"
                                     else [torch.from_numpy(c)])
    with torch.no_grad():
        got = tm(*targs)
    want = jm.apply(v, *args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), _np(w_), rtol=1e-5, atol=2e-5)


def test_use_kernel_switch():
    cpu = torch.zeros(1)
    assert tmod.use_kernel("auto", cpu) is False
    assert tmod.use_kernel("torch", cpu) is False
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tmod.use_kernel("cuda", cpu)
    with pytest.raises(ValueError):
        tmod.use_kernel("xla", cpu)
