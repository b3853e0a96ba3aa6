"""PyTorch port, training forward and backward of the model on the CPU
against the JAX package:
  - a train-mode S LeMeBlock against the JAX LeMeBlock(attn_backend=
    "pallas") run in interpret mode (tests/test_pallas_train.py's way), on
    the composed path and on the training-kernel path (the autograd
    Function's plain phases): loss 2e-4, every gradient 5e-3;
  - one whole train step of an S-only micro vit_tiny against JAX's
    create_train_state + make_train_step + build_optimizer (attn_backend
    "xla"): loss 2e-4, grad norm, every parameter's update, the BatchNorm
    running statistics and the EMA parameters 5e-3;
  - the repairs: BatchNorm's train-mode running variance (flax's biased
    one), DropPath's explicit generator, the JAX package's token-count
    limits of the block kernels; and C / D blocks refusing to compose
    quietly where their training kernels would run; remat.
All fp32."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from lemevit_tpu.attn import pallas_block
from lemevit_tpu.models import LeMeViT as JLeMeViT
from lemevit_tpu.models.lemevit import LeMeBlock as JBlock
from lemevit_tpu.train import build_optimizer as j_build_optimizer
from lemevit_tpu.train import create_train_state, make_train_step
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.core import layers as tl
from lemevit_tpu_torch.models import lemevit as tmod
from lemevit_tpu_torch.models.convert import from_jax_params
from lemevit_tpu_torch.train.optim import build_optimizer
from lemevit_tpu_torch.train.state import ModelEma, TrainState
from lemevit_tpu_torch.train.steps import train_step

C, H, M = 64, 2, 16
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
MICRO = dict(depth=(1, 1, 1, 1), embed_dim=(16, 32, 32, 32), head_dim=8,
             mlp_ratios=(4, 4, 4, 4), attn_type=("S", "S", "S", "S"),
             queries_len=8, num_classes=10)
LR = 0.1
EMA_DECAY = 0.996
BN_FED_BIASES = {"downsample_layers.0.0.bias", "downsample_layers.0.3.bias",
                 "downsample_layers.1.0.bias", "downsample_layers.2.0.bias",
                 "downsample_layers.3.0.bias"}


def _live_grad(name, t):
    """Mask of the elements whose exact gradient is not structurally zero.
    Zero are: a conv bias feeding a train-mode BatchNorm (the batch mean is
    subtracted) and the key third of a qkv bias (it shifts a query's scores
    alike, which softmax ignores). There the gradient is rounding noise in
    either framework and Adam's first step +-LR on its sign, so those
    elements are only held to that bound."""
    keep = np.ones(tuple(t.shape), bool)
    if name in BN_FED_BIASES:
        keep[:] = False
    elif name.endswith("attn.qkv.bias"):
        ch = t.shape[0] // 3
        keep[ch:2 * ch] = False
    return keep


@pytest.fixture
def kernel_path(monkeypatch):
    """Send every block that the kernels take down its kernel path on the
    CPU, where the wrappers run their plain versions."""
    monkeypatch.setattr(tmod, "use_kernel",
                        lambda backend, t: backend != "torch")


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _block_sd(tree):
    """Port LeMeBlock("S") state_dict from a JAX block's params."""
    def lin(p):
        return {"weight": _np(p["kernel"]).T, "bias": _np(p["bias"])}

    def ln(p):
        return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}
    parts = {
        "pos_embed": {"weight": np.transpose(
            _np(tree["pos_embed"]["dwconv"]["kernel"]), (3, 2, 0, 1)),
            "bias": _np(tree["pos_embed"]["dwconv"]["bias"])},
        "norm1": ln(tree["norm1"]), "norm2": ln(tree["norm2"]),
        "attn.qkv": lin(tree["attn"]["qkv"]),
        "attn.proj": lin(tree["attn"]["proj"]),
        "mlp.0": lin(tree["mlp"]["fc1"]), "mlp.3": lin(tree["mlp"]["fc2"])}
    return {f"{k}.{w}": torch.from_numpy(np.ascontiguousarray(v))
            for k, d in parts.items() for w, v in d.items()}


def _randomize(tree, rng):
    if isinstance(tree, dict):
        return {k: _randomize(v, rng) for k, v in tree.items()}
    return jnp.asarray(_np(tree) + 0.1 * rng.randn(*tree.shape))


@pytest.mark.parametrize("path", ["composed", "kernel"])
def test_block_train_matches_jax(monkeypatch, request, path):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, C).astype(np.float32)
    c = rng.randn(2, M, C).astype(np.float32)
    jb = JBlock(dim=C, num_heads=H, attn_type="S", attn_backend="pallas")
    v = JBlock(dim=C, num_heads=H, attn_type="S", attn_backend="xla").init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(c))
    v = {"params": _randomize(v["params"], rng)}

    def jloss(v_, x_, c_):
        xo, co = jb.apply(v_, x_, c_, False)  # train mode
        return jnp.sum(xo ** 2) + jnp.sum(co ** 2)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        v, jnp.asarray(x), jnp.asarray(c))

    tb = tmod.LeMeBlock(C, H, "S").train()
    tb.load_state_dict(_block_sd(v["params"]), strict=True)
    tx = torch.tensor(x, requires_grad=True)
    tc = torch.tensor(c, requires_grad=True)
    before = dict(ft.LAUNCHES)
    xo, co = tb(tx, tc)
    loss = (xo ** 2).sum() + (co ** 2).sum()
    loss.backward()
    assert ft.LAUNCHES == before  # CPU tensors: plain phases, no launches
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    want = _block_sd(jg[0]["params"])
    for name, p in tb.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jg[1]), **GRAD_TOL)
    np.testing.assert_allclose(tc.grad.numpy(), _np(jg[2]), **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _jax_train_step():
    """Inputs, the state before and after one JAX train step, and its
    metrics (numpy), for the S-only micro model at 32^2, B = 4."""
    rng = np.random.RandomState(1)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 4)
    targets = np.eye(10, dtype=np.float32)[labels] * 0.9 + 0.01
    jm = JLeMeViT(**MICRO, attn_backend="xla")
    tx = j_build_optimizer(lambda s: LR, weight_decay=0.05)
    st = create_train_state(jm, jax.random.PRNGKey(0), (2, 32, 32, 3), tx,
                            ema_decay=EMA_DECAY)
    stats = jax.tree.map(
        lambda a: jnp.asarray(_np(a) + 0.5 * rng.rand(*a.shape)),
        st.batch_stats)
    params = _randomize(st.params, rng)
    st = st.replace(params=params, batch_stats=stats,
                    ema_params=jax.tree.map(jnp.copy, params),
                    opt_state=tx.init(params))
    step = jax.jit(make_train_step(label_smoothing=0.0))
    new, metrics = step(st, {"image": jnp.asarray(x),
                             "label": jnp.asarray(targets)},
                        jax.random.PRNGKey(1))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (x, targets, to_np(st.variables), to_np(new.variables),
            to_np({"params": new.ema_params,
                   "batch_stats": new.batch_stats}),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("path", ["composed", "kernel"])
def test_train_step_matches_jax(request, path):
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    x, targets, v0, v1, ema1, jmetrics = _jax_train_step()
    tm = tmod.LeMeViT(**MICRO)
    sd0 = from_jax_params(v0, tm)
    tm.load_state_dict(sd0, strict=True)
    state = TrainState(tm, build_optimizer(tm, weight_decay=0.05),
                       lambda u: LR, ModelEma(tm, EMA_DECAY))
    metrics = train_step(state, torch.from_numpy(x),
                         torch.from_numpy(targets))
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), jmetrics["loss"],
                               **LOSS_TOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               jmetrics["grad_norm"], rtol=5e-3)
    want = from_jax_params(v1, tm)
    want_ema = from_jax_params(ema1, tm)
    got = tm.state_dict()
    params = dict(tm.named_parameters())
    for name, t in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name in params:
            # the update, in units of the LR (Adam's first step is ~ +-LR),
            # of the live and the EMA parameters
            keep = _live_grad(name, t)
            for tag, new, ref, scale in (
                    ("", t, want[name], LR),
                    ("ema ", state.ema.params[name], want_ema[name],
                     (1 - EMA_DECAY) * LR)):
                got_u = ((new - sd0[name]) / scale).numpy()
                want_u = ((ref - sd0[name]) / scale).numpy()
                np.testing.assert_allclose(got_u[keep], want_u[keep],
                                           **GRAD_TOL, err_msg=tag + name)
                assert np.abs(got_u[~keep]).max(initial=0) <= 1 + 1e-4
        else:  # BatchNorm running statistics
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       **GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------- repairs


def test_batchnorm_running_var_is_flax_biased():
    """Train-mode BatchNorm updates the running variance with the biased
    batch variance, as flax does (torch's own BatchNorm2d takes the
    unbiased one); output and running mean as before."""
    x = np.random.RandomState(3).randn(2, 3, 3, 4).astype(np.float32)
    fb = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = fb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                use_running_average=False)
    y, upd = fb.apply(v, jnp.asarray(x), use_running_average=False,
                      mutable=["batch_stats"])
    bn = tl.BatchNorm(4, eps=1e-5).train()
    out = tl.nhwc_conv(bn, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), _np(y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               _np(upd["batch_stats"]["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               _np(upd["batch_stats"]["var"]), rtol=1e-5)
    torch_bn = torch.nn.BatchNorm2d(4, eps=1e-5).train()
    tl.nhwc_conv(torch_bn, torch.from_numpy(x))
    assert not np.allclose(torch_bn.running_var.numpy(),
                           bn.running_var.numpy(), rtol=1e-3)
    bn.eval()
    torch_bn.load_state_dict(bn.state_dict())
    torch_bn.eval()
    torch.testing.assert_close(tl.nhwc_conv(bn, torch.from_numpy(x)),
                               tl.nhwc_conv(torch_bn, torch.from_numpy(x)))


def test_drop_path_generator_reproducible():
    x = torch.randn(64, 5, 8)
    outs = []
    for seed in (7, 7, 8):
        dp = tl.DropPath(0.5).train()
        dp.generator = torch.Generator().manual_seed(seed)
        outs.append(dp(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(RuntimeError, match="torch.Generator"):
        tl.DropPath(0.5).train()(x)


def test_model_drop_path_draws_from_set_generator():
    m = tmod.LeMeViT(**MICRO, drop_path_rate=0.5).train()
    x = torch.randn(4, 32, 32, 3)
    outs = []
    for _ in range(2):
        m.set_generator(torch.Generator().manual_seed(3))
        outs.append(m(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_dispatch_takes_jax_token_limits(kernel_path):
    """The S kernels only up to N = 1024, C / D blocks up to 3136, as the
    JAX package; vit_tiny's stage 0 (N = 3136) composes."""
    s = tmod.LeMeBlock(32, 1, "S")
    d = tmod.LeMeBlock(32, 1, "D")
    x1024, x3136 = torch.zeros(1, 32, 32, 32), torch.zeros(1, 56, 56, 32)
    assert s._fusable(x1024) and not s._fusable(x3136)
    assert d._fusable(x3136) and not d._fusable(torch.zeros(1, 1, 3137, 32))
    assert tmod.kernel_takes("S", 784) and not tmod.kernel_takes("S", 3136)


@pytest.mark.parametrize("attn_type", ["C", "D", "D2"])
def test_cd_blocks_refuse_to_train_without_kernels(kernel_path, attn_type):
    blk = tmod.LeMeBlock(32, 1, attn_type).train()
    x, c = torch.randn(2, 4, 4, 32), torch.randn(2, 4, 32)
    with pytest.raises(NotImplementedError, match="attn-backend torch"):
        blk(x, c)
    blk.attn_backend = "torch"
    xo, co = blk(x, c)
    assert xo.shape == x.shape and co.shape == c.shape


def test_remat_stages_keep_masks_and_gradients():
    """Recomputing stages in the backward (torch.utils.checkpoint) gives
    the gradients of the plain run: the DropPath masks are drawn once,
    outside the recomputed function."""
    x = torch.randn(4, 32, 32, 3)
    grads = []
    for remat in ((), (0, 1, 2, 3)):
        torch.manual_seed(0)
        m = tmod.LeMeViT(**MICRO, drop_path_rate=0.5, remat_stages=remat)
        tl.init_weights(m, torch.Generator().manual_seed(0))
        m.train().set_generator(torch.Generator().manual_seed(5))
        m(x).square().sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
