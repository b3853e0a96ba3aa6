"""PyTorch port, S-block training kernels (attn/fused_train.py): the
Function's plain phases on the CPU against the JAX package's
pallas_train.s_block_train (interpret mode, as tests/test_pallas_train.py
runs it) and against the port's own autograd composition. fp32; outputs at
rtol = atol = 2e-4 and gradients at 5e-3, the JAX suite's tolerances. The
CUDA kernels are held against the plain phases on the card in
tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_train as ft

B, N, C, H, M = 4, 64, 64, 2, 16
OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


def make_inputs(seed, b=B, n=N, ch=C, hidden=2 * C, keep=0.7):
    """x, c, the folded 8-tuple (torch layout) and the (4, B) DropPath
    scales, as float32 numpy."""
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    x, c = r(b, n, ch), r(b, M, ch)
    params = [r(3 * ch, ch), r(3 * ch), r(ch, ch), r(ch), r(hidden, ch),
              r(hidden), r(ch, hidden), r(ch)]
    dp = ((rng.rand(4, b) < keep) / keep).astype(np.float32)
    return x, c, params, dp


def loss_weights(xs, cs):
    wx = np.sin(np.arange(np.prod(xs), dtype=np.float32)).reshape(xs)
    wc = np.cos(np.arange(np.prod(cs), dtype=np.float32)).reshape(cs)
    return wx, wc


def torch_run(fn, x, c, params, dp):
    """Outputs and gradients of x, c and the 8 params under fn."""
    ts = [torch.tensor(a, requires_grad=True) for a in (x, c, *params)]
    xo, co = fn(ts[0], ts[1], ts[2:], torch.from_numpy(dp), num_heads=H)
    wx, wc = loss_weights(xo.shape, co.shape)
    loss = (xo * torch.from_numpy(wx)).sum() + (co * torch.from_numpy(wc)).sum()
    loss.backward()
    return ([xo.detach().numpy(), co.detach().numpy()],
            [t.grad.numpy() for t in ts])


def test_s_block_train_matches_jax(interpret):
    x, c, params, dp = make_inputs(0)
    jp = tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)
    jdp = tuple(jnp.asarray(dp[i]) for i in range(4))

    def jfn(x_, c_, p_):
        return pallas_train.s_block_train(x_, c_, p_, jdp, num_heads=H)

    jout = jfn(jnp.asarray(x), jnp.asarray(c), jp)
    assert jout is not None
    wx, wc = loss_weights(x.shape, c.shape)

    def jloss(x_, c_, p_):
        xo, co = jfn(x_, c_, p_)
        return jnp.sum(xo * wx) + jnp.sum(co * wc)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(c),
                                            jp)
    jgrads = [jg[0], jg[1]] + [np.asarray(g).T if g.ndim == 2 else g
                               for g in jg[2]]
    before = dict(ft.LAUNCHES)
    outs, grads = torch_run(ft.s_block_train, x, c, params, dp)
    assert ft.LAUNCHES == before  # CPU tensors take the plain phases
    for got, want in zip(outs, jout):
        np.testing.assert_allclose(got, np.asarray(want), **OUT_TOL)
    assert len(grads) == len(jgrads) == 10
    for i, (got, want) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("n", [64, 49])
def test_function_matches_autograd_composition(n):
    """The three explicit phases against autograd through the composed
    block (every gradient), with ragged n and all-ones scales."""
    x, c, params, dp = make_inputs(1, n=n)
    if n == 49:
        dp = np.ones_like(dp)
    outs_f, grads_f = torch_run(ft.s_block_train, x, c, params, dp)
    outs_p, grads_p = torch_run(ft.s_block_train_plain, x, c, params, dp)
    for got, want in zip(outs_f, outs_p):
        np.testing.assert_allclose(got, want, **OUT_TOL)
    for i, (got, want) in enumerate(zip(grads_f, grads_p)):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"gradient {i}")


def test_fold_ln_matches_layer_norm():
    rng = np.random.RandomState(2)
    t = torch.from_numpy(rng.randn(3, 5, C).astype(np.float32))
    g, be = (torch.from_numpy(rng.randn(C).astype(np.float32))
             for _ in range(2))
    w = torch.from_numpy(rng.randn(2 * C, C).astype(np.float32))
    b = torch.from_numpy(rng.randn(2 * C).astype(np.float32))
    want = torch.nn.functional.linear(
        torch.nn.functional.layer_norm(t, (C,), g, be, ft.LN_EPS), w, b)
    wf, bf = ft.fold_ln(g, be, w, b)
    got = torch.nn.functional.linear(ft._norm(t), wf, bf)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_wgrad_tc_split_covers_rows():
    """The row ranges of k_wgrad_tc (every block's backwards, all products
    of a launch) cover each stream's rows, aligned to its
    64-row step, at least 128 rows each, about two CTAs an SM over the
    products and not far past it."""
    for rows0, rows1, shapes in [(12544, 1024, [(1536, 384), (384, 1536)]),
                                 (128, 64, [(96, 32)]),
                                 (50176, 1024, [(576, 192), (192, 192)]),
                                 (0, 1024, [(256, 64), (64, 256)])]:
        rps, splits = ft._wgrad_tc_split(rows0, rows1, shapes, 132)
        assert rps % 64 == 0 and rps >= 128
        assert splits == -(-rows0 // rps) + -(-rows1 // rps)
        tiles = sum(-(-o // ft.WGRAD_TC_TILE) * -(-i // ft.WGRAD_TC_TILE)
                    for o, i in shapes)
        assert rps == 128 or tiles * (splits - 2) <= 2 * 132


@pytest.mark.parametrize("ch", [544, 640])
@pytest.mark.parametrize("name,kind", [("s_train_fwd", "s"),
                                       ("dca_train_fwd", "dca"),
                                       ("c_train_fwd", "c")])
def test_training_forward_refuses_past_max_train_dim(name, kind, ch):
    """Widths that the inference kernels take (up to fused_block.MAX_DIM)
    but the training backward's row kernels do not are refused by each
    forward phase's check, before anything runs: every block's backward
    runs mlp_bwd."""
    x = torch.zeros(1, 1, ch)
    params = [torch.zeros(s) for s in ft._param_shapes(kind, ch, 4 * ch)]
    with pytest.raises(ValueError, match="MAX_TRAIN_DIM"):
        ft._check(name, kind, x, x, params, torch.ones(4, 1), ch // 32)


def test_max_train_dim_takes_every_registered_width():
    """MAX_TRAIN_DIM admits every stage width of the registry's variants and
    stays under the inference kernels' MAX_DIM."""
    from lemevit_tpu_torch.models.registry import list_models, variant_config
    assert ft.fb.MAX_DIM > ft.MAX_TRAIN_DIM == 512
    widths = {ch for name in list_models()
              for ch in variant_config(name)["embed_dim"]}
    assert max(widths) <= ft.MAX_TRAIN_DIM
    for ch in sorted(widths):
        ft._check_train_dim("s_train_fwd", ch)
