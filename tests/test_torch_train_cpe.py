"""PyTorch port, the 3x3 CPE inside the training kernels
(attn/fused_train.py's ``cpe=`` mode; the model's ``train_cpe_in_kernel``,
the JAX package's ``PB_TRAIN_CPE=fused``), on the CPU:
  - s_block_train, dca_block_train and c_block_train with ``cpe=`` (the
    Functions' plain phases) against the JAX package's pallas_train kernels
    with ``cpe=`` in interpret mode, on a non-square image with B = 4:
    outputs 2e-4, every gradient (the taps' and the bias's included) 5e-3,
    tests/test_pallas_train.py's tolerances;
  - cpe_rows_plain, cpe_tap_grads_plain and the flipped-tap transpose
    against fused_block.cpe_plain (a depthwise F.conv2d, padding 1) and
    its autograd, on 3x5 images with B = 2 (1e-5);
  - a train-mode C, D, D2 and S LeMeBlock on the kernel path with the switch
    on and off, on the same weights and DropPath scales: outputs 2e-4, the
    gradients of x, c and every parameter (pos_embed's included) 5e-3; with
    the switch on the block's depthwise conv does not run;
  - whole train steps with the switch on against JAX's train step under
    PB_TRAIN_CPE=fused (attn_backend "pallas", interpret mode), with
    tests/test_torch_train_model.py's tolerances: a micro C / D model at
    the kernels' head_dim 32, where JAX runs its training kernels with the
    CPE inside, and lemevit_micro, whose 4 meta tokens JAX's kernels decline
    (it composes there);
  - a CPE that is not 3x3 declines: the block composes, as JAX's
    _try_fused_train does.
All fp32. The CUDA kernels are held against the plain phases on the card in
tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import pallas_block, pallas_dca, pallas_mhsa
from lemevit_tpu.attn import pallas_train
from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales
from lemevit_tpu_torch.models import lemevit as tmod
from tests import test_torch_train_model as ttm

B, C, H, M = 4, 64, 2, 16
IMG_H, IMG_W = 6, 8          # non-square, so that H / W swaps show
N = IMG_H * IMG_W
OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
KINDS = {"s": "s_block_train", "dca": "dca_block_train",
         "c": "c_block_train"}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)


@pytest.fixture
def kernel_path(monkeypatch):
    """Send every block that the kernels take down its kernel path on the
    CPU, where the wrappers run their plain versions."""
    monkeypatch.setattr(tmod, "use_kernel",
                        lambda backend, t: backend != "torch")


def make_inputs(kind, seed, keep=0.7):
    """Pre-CPE x, c, the CPE's taps (9, C) and bias, the folded parameter
    tuple (torch layout, hidden = 2C) and the (4, B) DropPath scales, as
    float32 numpy."""
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    x, c = r(B, N, C), r(B, M, C)
    taps, bias = 2 * r(9, C), 2 * r(C)
    params = [r(*s) for s in ft._param_shapes(kind, C, 2 * C)]
    dp = ((rng.rand(4, B) < keep) / keep).astype(np.float32)
    return x, c, taps, bias, params, dp


def weights(*shapes):
    """Fixed loss weights, one array per output."""
    return [np.sin(np.arange(np.prod(s), dtype=np.float32) * (i + 1)
                   ).reshape(s) for i, s in enumerate(shapes)]


def _kw(kind):
    kw = {"num_heads": H}
    if kind == "dca":
        kw["scale_x"], kw["scale_c"] = dca_scales(N, M, C)
    return kw


def torch_run(kind, fn, x, c, taps, bias, params, dp):
    """Outputs and the gradients of x, c, taps, bias and every parameter
    under the port's block function ``fn`` with the CPE inside."""
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, c, taps, bias, *params)]
    outs = fn(ts[0], ts[1], ts[4:], torch.from_numpy(dp), cpe=ts[2:4],
              img_w=IMG_W, **_kw(kind))
    outs = outs if isinstance(outs, tuple) else (outs,)
    ws = weights(*(o.shape for o in outs))
    sum(((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws))
        ).backward()
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() for t in ts])


def jax_run(kind, x, c, taps, bias, params, dp):
    """The JAX package's training block with cpe=: outputs and the
    gradients of x, c, taps, bias and every parameter (torch layout)."""
    jp = tuple(jnp.asarray(a.T if a.ndim == 2 else a) for a in params)
    jdp = tuple(jnp.asarray(dp[i]) for i in range(4))
    fn = getattr(pallas_train, KINDS[kind])

    def run(x_, c_, cpe_, p_):
        out = fn(x_, c_, p_, jdp, cpe=cpe_, img_w=IMG_W, **_kw(kind))
        return out if isinstance(out, tuple) else (out,)

    args = (jnp.asarray(x), jnp.asarray(c),
            (jnp.asarray(taps), jnp.asarray(bias)), jp)
    outs = run(*args)
    assert outs[0] is not None  # the JAX package takes these shapes
    ws = weights(*(o.shape for o in outs))

    def loss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(run(*a), ws))

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    grads = [g[0], g[1], g[2][0], g[2][1]] + [
        np.asarray(t).T if t.ndim == 2 else t for t in g[3]]
    return [np.asarray(o) for o in outs], [np.asarray(t) for t in grads]


@pytest.mark.parametrize("kind", ["s", "dca", "c"])
def test_block_train_cpe_matches_jax(interpret, kind):
    """The outputs and the gradients of x, c, the taps, the bias and every
    parameter of the port's Function with cpe= against JAX's."""
    x, c, taps, bias, params, dp = make_inputs(kind, 0)
    jouts, jgrads = jax_run(kind, x, c, taps, bias, params, dp)
    before = dict(ft.LAUNCHES)
    outs, grads = torch_run(kind, getattr(ft, KINDS[kind]), x, c, taps, bias,
                            params, dp)
    assert ft.LAUNCHES == before  # CPU tensors take the plain phases
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got, want, **OUT_TOL)
    assert len(grads) == len(jgrads) == 4 + len(params)
    for i, (got, want) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("kind", ["s", "dca", "c"])
def test_function_cpe_matches_autograd_composition(kind):
    """The explicit phases with cpe= against autograd through the composed
    block (*_block_train_plain with cpe=), every gradient."""
    x, c, taps, bias, params, dp = make_inputs(kind, 1)
    outs_f, grads_f = torch_run(kind, getattr(ft, KINDS[kind]), x, c, taps,
                                bias, params, dp)
    outs_p, grads_p = torch_run(kind, getattr(ft, KINDS[kind] + "_plain"),
                                x, c, taps, bias, params, dp)
    for got, want in zip(outs_f, outs_p):
        np.testing.assert_allclose(got, want, **OUT_TOL)
    for i, (got, want) in enumerate(zip(grads_f, grads_p)):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"gradient {i}")


def test_cpe_plain_forms_match_conv2d():
    """cpe_rows_plain is x + the depthwise conv; cpe_tap_grads_plain and
    the flipped-tap, bias-free cpe_rows_plain are the conv's tap / bias
    gradients and its input gradient (the identity term included), on 3x5
    images, B = 2, where a row or column swap or a shift across images
    would show."""
    rng = np.random.RandomState(3)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x, taps, bias, du = t(2, 15, 32), t(9, 32), t(32), t(2, 15, 32)
    xs, ts, bs = (a.clone().requires_grad_() for a in (x, taps, bias))
    want = fb.cpe_plain(xs, ts, bs, 5)
    want.backward(du)
    torch.testing.assert_close(ft.cpe_rows_plain(x, taps, bias, 5), want,
                               rtol=1e-5, atol=1e-5)
    dtaps, dbias = ft.cpe_tap_grads_plain(x, du, 5)
    torch.testing.assert_close(dtaps, ts.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dbias, bs.grad, rtol=1e-5, atol=1e-5)
    dx = ft.cpe_rows_plain(du, taps.flip(0), None, 5)
    torch.testing.assert_close(dx, xs.grad, rtol=1e-5, atol=1e-5)
    # the transpose of a 5-wide image is not that of a 3-wide one
    assert not torch.allclose(ft.cpe_rows_plain(du, taps.flip(0), None, 3),
                              dx, atol=1e-3)


def _count_conv_calls(block):
    calls = []
    block.pos_embed.register_forward_hook(lambda *a: calls.append(1))
    return calls


@pytest.mark.parametrize("attn_type", ["C", "D", "D2", "S"])
def test_block_switch_on_matches_off(kernel_path, attn_type):
    """A train-mode block with train_cpe_in_kernel on (pre-CPE x into the
    Function) and off (the depthwise conv outside it) on the same weights
    and DropPath scales: outputs and the gradients of x, c and every
    parameter, pos_embed's included. With the switch on the conv does not
    run; the C block passes x through either way."""
    torch.manual_seed(0)
    on = tmod.LeMeBlock(C, H, attn_type, drop_path=0.3,
                        train_cpe_in_kernel=True).train()
    with torch.no_grad():
        for p in on.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    off = tmod.LeMeBlock(C, H, attn_type, drop_path=0.3).train()
    off.load_state_dict(on.state_dict())
    rng = np.random.RandomState(5)
    x = rng.randn(2, IMG_H, IMG_W, C).astype(np.float32)
    c = rng.randn(2, M, C).astype(np.float32)
    dp = torch.from_numpy(((rng.rand(4, 2) < 0.7) / 0.7).astype(np.float32))
    runs = []
    for blk in (on, off):
        calls = _count_conv_calls(blk)
        xs, cs = (torch.tensor(a, requires_grad=True) for a in (x, c))
        xo, co = blk(xs, cs, dp)
        assert (xo is xs) == (attn_type == "C")
        (xo.square().sum() + co.square().sum()).backward()
        runs.append(([xo.detach(), co.detach()],
                     [xs.grad, cs.grad] + [p.grad for p in blk.parameters()],
                     len(calls)))
    assert runs[0][2] == 0 and runs[1][2] == 1
    for got, want in zip(runs[0][0], runs[1][0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **OUT_TOL)
    names = ["x", "c"] + [n for n, _ in on.named_parameters()]
    assert "pos_embed.weight" in names and "pos_embed.bias" in names
    for name, got, want in zip(names, runs[0][1], runs[1][1]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("config", ["CD", "micro"])
def test_train_step_with_switch_matches_jax_fused(monkeypatch, kernel_path,
                                                  config):
    """One train step with train_cpe_in_kernel against JAX's step with
    PB_TRAIN_CPE=fused on its Pallas path (interpret mode): loss, grad
    norm, every parameter's update and the EMA's, the BatchNorm
    statistics."""
    for mod in (pallas_block, pallas_dca, pallas_mhsa):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setenv("PB_TRAIN_CPE", "fused")
    # uncached: the cache's key does not hold the environment
    jstep = ttm._jax_train_step.__wrapped__(config, backend="pallas")
    calls = []
    real = ft.dca_block_train

    def spy(*a, **kw):
        calls.append(kw["cpe"] is not None)
        return real(*a, **kw)
    monkeypatch.setattr(ft, "dca_block_train", spy)
    ttm.check_train_step(config, jstep, train_cpe_in_kernel=True)
    assert calls == [True, True]  # both D blocks, their CPEs inside


def test_non_3x3_cpe_declines(kernel_path, monkeypatch):
    """With the switch on, a block whose CPE is not 3x3 composes (the JAX
    package's _cpe_weights raises LookupError and _try_fused_train returns
    None), and gives the switch-off block's result; a 3x3 one runs its
    training kernels with the CPE inside."""
    calls = []
    real = ft.s_block_train

    def spy(*a, **kw):
        calls.append(kw["cpe"] is not None)
        return real(*a, **kw)
    monkeypatch.setattr(ft, "s_block_train", spy)
    x = torch.randn(2, 4, 4, 32)
    c = torch.randn(2, 8, 32)
    dp = torch.ones(4, 2)
    five = tmod.LeMeBlock(32, 1, "S", cpe_ks=5,
                          train_cpe_in_kernel=True).train()
    with pytest.raises(LookupError):
        five.cpe_weights()
    xo, co = five(x, c, dp)
    assert calls == []
    five.train_cpe_in_kernel = False
    ref = five(x, c, dp)
    assert calls == [False]  # off: the kernels with the conv outside
    torch.testing.assert_close(xo, ref[0], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(co, ref[1], rtol=2e-4, atol=2e-4)
    three = tmod.LeMeBlock(32, 1, "S", train_cpe_in_kernel=True).train()
    three(x, c, dp)
    assert calls == [False, True]


@pytest.mark.parametrize("flags", [[], ["--train-cpe-in-kernel"]])
def test_cli_switch_reaches_the_model(tmp_path, kernel_path, monkeypatch,
                                      flags):
    """cli.train and cli.benchmark --bench train build the model with
    train_cpe_in_kernel as --train-cpe-in-kernel says (off by default) and
    train lemevit_micro on the CPU; with the switch the D blocks' training
    kernels get the CPE."""
    import math

    from lemevit_tpu_torch.cli import benchmark
    from lemevit_tpu_torch.cli import train as train_cli
    from lemevit_tpu_torch.models import registry
    made, cpes = [], []
    real_create, real_dca = registry.create_model, ft.dca_block_train

    def create(*a, **kw):
        made.append(kw.get("train_cpe_in_kernel"))
        return real_create(*a, **kw)

    def dca(*a, **kw):
        cpes.append(kw["cpe"] is not None)
        return real_dca(*a, **kw)
    monkeypatch.setattr(registry, "create_model", create)
    monkeypatch.setattr(ft, "dca_block_train", dca)
    res = train_cli.main([
        "--synthetic", "--model", "lemevit_micro", "--img-size", "32",
        "--batch-size", "2", "--num-classes", "5", "--device", "cpu",
        "--epochs", "1", "--steps-per-epoch", "1", "--no-model-ema",
        "--output", str(tmp_path), *flags])
    assert res["steps"] == 1 and math.isfinite(res["train_loss"])
    bres = benchmark.main([
        "--model", "lemevit_micro", "--bench", "train", "--img-size", "32",
        "--batch-size", "2", "--num-classes", "5", "--device", "cpu",
        "--num-warm-iter", "1", "--num-bench-iter", "1", *flags])
    assert bres["train"]["samples_per_sec"] > 0
    on = bool(flags)
    assert made == [on, on]
    assert cpes and all(c == on for c in cpes)


def test_cpe_split_covers_rows():
    """k_cpe_tap_grads' row ranges cover every row once, in blocks of at
    least CPE_GRAD_ROWS rows (a multiple of 8), about four per
    multiprocessor at lemevit_tiny's and base's token counts."""
    for rows in (64 * 3136, 64 * 784, 64 * 196, 64 * 49, 8 * 49, 15):
        rps, splits = ft._cpe_split(rows, 132)
        assert rps % 8 == 0 and rps >= ft.CPE_GRAD_ROWS
        assert (splits - 1) * rps < rows <= splits * rps
        assert splits <= 4 * 132
