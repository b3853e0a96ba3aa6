"""PyTorch port, D- and C-block training kernels (attn/fused_train.py:
dca_block_train, c_block_train): the Functions' plain phases on the CPU
against the JAX package's pallas_train.dca_block_train / c_block_train
(interpret mode, as tests/test_pallas_train.py runs them) and against the
port's own autograd compositions. fp32; outputs at rtol = atol = 2e-4 and
gradients at 5e-3, the JAX suite's tolerances. The CUDA kernels are held
against the plain phases on the card in tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales

B, N, C, H, M = 4, 64, 64, 2, 16
OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
# torch-layout parameter shapes of each block, hidden = 2C
SHAPES = {
    "dca": [(3 * C, C), (3 * C,), (3 * C, C), (3 * C,), (C, C), (C,),
            (C, C), (C,), (2 * C, C), (2 * C,), (C, 2 * C), (C,)],
    "c": [(C, C), (C,), (2 * C, C), (2 * C,), (C, C), (C,), (2 * C, C),
          (2 * C,), (C, 2 * C), (C,)],
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def make_inputs(kind, seed, n=N, keep=0.7):
    """x, c, the folded parameter tuple (torch layout) and the (4, B)
    DropPath scales, as float32 numpy."""
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    x, c = r(B, n, C), r(B, M, C)
    params = [r(*s) for s in SHAPES[kind]]
    dp = ((rng.rand(4, B) < keep) / keep).astype(np.float32)
    return x, c, params, dp


def weights(*shapes):
    """Fixed loss weights, one array per output."""
    return [np.sin(np.arange(np.prod(s), dtype=np.float32) * (i + 1)
                   ).reshape(s) for i, s in enumerate(shapes)]


def block(kind, fn, n):
    """fn(x, c, params, dp) -> tuple of outputs, for the kernel-phase
    Function ("fused") or the autograd composition ("plain")."""
    name = {"dca": "dca_block_train", "c": "c_block_train"}[kind]
    f = getattr(ft, name if fn == "fused" else name + "_plain")
    if kind == "c":
        return lambda x, c, p, dp: (f(x, c, p, dp, num_heads=H),)
    sx, sc = dca_scales(n, M, C)
    return lambda x, c, p, dp: f(x, c, p, dp, num_heads=H, scale_x=sx,
                                 scale_c=sc)


def torch_run(fn, x, c, params, dp):
    """Outputs and the gradients of x, c and every parameter under fn."""
    ts = [torch.tensor(a, requires_grad=True) for a in (x, c, *params)]
    outs = fn(ts[0], ts[1], ts[2:], torch.from_numpy(dp))
    ws = weights(*(o.shape for o in outs))
    sum(((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws))
        ).backward()
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() for t in ts])


def jax_run(kind, x, c, params, dp):
    """The JAX package's fused training block: outputs and gradients of
    x, c and every parameter (torch layout)."""
    jp = tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)
    jdp = tuple(jnp.asarray(dp[i]) for i in range(4))
    sx, sc = dca_scales(x.shape[1], M, C)

    def fn(x_, c_, p_):
        if kind == "c":
            return (pallas_train.c_block_train(x_, c_, p_, jdp,
                                               num_heads=H),)
        return pallas_train.dca_block_train(x_, c_, p_, jdp, num_heads=H,
                                            scale_x=sx, scale_c=sc)

    outs = fn(jnp.asarray(x), jnp.asarray(c), jp)
    assert outs[0] is not None  # the JAX package takes these shapes
    ws = weights(*(o.shape for o in outs))

    def loss(x_, c_, p_):
        return sum(jnp.sum(o * w) for o, w in zip(fn(x_, c_, p_), ws))

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(c), jp)
    grads = [g[0], g[1]] + [np.asarray(t).T if t.ndim == 2 else t
                            for t in g[2]]
    return [np.asarray(o) for o in outs], [np.asarray(t) for t in grads]


@pytest.mark.parametrize("kind", ["dca", "c"])
def test_block_train_matches_jax(interpret, kind):
    """Both outputs (D) or c (C), and the gradients of x, c and every
    parameter (14 for D, 12 for C) of the kernel phases against JAX."""
    x, c, params, dp = make_inputs(kind, 0)
    jouts, jgrads = jax_run(kind, x, c, params, dp)
    before = dict(ft.LAUNCHES)
    outs, grads = torch_run(block(kind, "fused", N), x, c, params, dp)
    assert ft.LAUNCHES == before  # CPU tensors take the plain phases
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got, want, **OUT_TOL)
    assert len(grads) == len(jgrads) == 2 + len(SHAPES[kind])
    for i, (got, want) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("n", [64, 49])
@pytest.mark.parametrize("kind", ["dca", "c"])
def test_function_matches_autograd_composition(kind, n):
    """The explicit phases against autograd through the composed block
    (every gradient), with ragged n and all-ones scales."""
    x, c, params, dp = make_inputs(kind, 1, n=n)
    if n == 49:
        dp = np.ones_like(dp)
    outs_f, grads_f = torch_run(block(kind, "fused", n), x, c, params, dp)
    outs_p, grads_p = torch_run(block(kind, "plain", n), x, c, params, dp)
    for got, want in zip(outs_f, outs_p):
        np.testing.assert_allclose(got, want, **OUT_TOL)
    for i, (got, want) in enumerate(zip(grads_f, grads_p)):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"gradient {i}")


def test_c_mlp_backward_takes_an_empty_image_stream():
    """The C block's MLP backward is mlp_bwd with no image tokens: the meta
    stream's results equal those of a call with both streams."""
    rng = np.random.RandomState(2)
    t = lambda *s: torch.from_numpy((rng.randn(*s) * 0.3).astype(np.float32))
    t1x, dxo, t1c, dco = t(B, 9, C), t(B, 9, C), t(B, M, C), t(B, M, C)
    w1, b1, w2 = t(2 * C, C), t(2 * C), t(C, 2 * C)
    dp = torch.from_numpy(make_inputs("c", 2)[3])
    none = t1x[:, :0]
    got = ft.mlp_bwd(none, t1c, none, dco, dp, w1, b1, w2)
    full = ft.mlp_bwd(t1x, t1c, dxo, dco, dp, w1, b1, w2)
    only_x = ft.mlp_bwd(t1x, t1c[:, :0], dxo, dco[:, :0], dp, w1, b1, w2)
    assert got[0].shape == (B, 0, C)
    torch.testing.assert_close(got[1], full[1])
    for g, f, xo in zip(got[2:], full[2:], only_x[2:]):
        torch.testing.assert_close(g, f - xo, rtol=1e-4, atol=1e-5)
