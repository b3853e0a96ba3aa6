"""PyTorch port, training forward and backward of the model on the CPU
against the JAX package:
  - a train-mode C, D, D2 and S LeMeBlock against the JAX
    LeMeBlock(attn_backend="pallas") run in interpret mode
    (tests/test_pallas_train.py's way), on the composed path and on the
    training-kernel path (the autograd Functions' plain phases): loss 2e-4,
    every gradient 5e-3;
  - one whole train step of an S-only micro vit_tiny and of C/D and C/D2
    micro LeMeViTs against JAX's create_train_state + make_train_step +
    build_optimizer (attn_backend "xla"): loss 2e-4, grad norm, every
    parameter's update, the BatchNorm running statistics and the EMA
    parameters 5e-3;
  - the repairs: BatchNorm's train-mode running variance (flax's biased
    one), DropPath's explicit generator, the JAX package's token-count
    limits of the block kernels; C / D / D2 blocks training on the kernel
    path; remat; the gradient norm and its clip over every parameter under
    frozen prefixes (a lemevit_micro step against JAX's
    build_optimizer(frozen_prefixes=..., clip_grad=...)).
All fp32."""
import functools
import re

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
from lemevit_tpu.train.steps import cross_entropy_loss as j_cross_entropy_loss
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.core import layers as tl
from lemevit_tpu_torch.models import lemevit as tmod
from lemevit_tpu_torch.models.convert import _ATTN_KEYS, from_jax_params
from lemevit_tpu_torch.train.optim import build_optimizer
from lemevit_tpu_torch.train.state import ModelEma, TrainState
from lemevit_tpu_torch.train.steps import train_step

C, H, M = 64, 2, 16
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
MICRO = dict(depth=(1, 1, 1, 1), embed_dim=(16, 32, 32, 32), head_dim=8,
             mlp_ratios=(4, 4, 4, 4), attn_type=("S", "S", "S", "S"),
             queries_len=8, num_classes=10)
# the C / D / D2 stages at the kernels' head_dim; at 32^2 the stages see
# 64, 64, 16, 4 and 1 image tokens
MICRO_CD = dict(depth=(1, 1, 1, 1, 1), embed_dim=(32, 32, 64, 64, 64),
                head_dim=32, mlp_ratios=(4, 4, 4, 4, 4),
                attn_type=("C", "D", "D", "S", "S"), queries_len=16,
                num_classes=10)
CONFIGS = {"S": MICRO, "CD": MICRO_CD,
           "CD2": dict(MICRO_CD, attn_type=("C", "D2", "D2", "S", "S")),
           # the registry's lemevit_micro (C, D, D, S, S at head_dim 8)
           "micro": dict(depth=(1, 1, 1, 1, 1),
                         embed_dim=(16, 16, 32, 32, 32), head_dim=8,
                         mlp_ratios=(2, 2, 2, 2, 2),
                         attn_type=("C", "D", "D", "S", "S"), queries_len=4,
                         num_classes=10)}
# Below this share of its tensor's largest gradient, an element's gradient
# lies within fp32 rounding of zero (the C/D models have such elements by
# chance, e.g. 3e-7 of 0.27 in CD's stage-2 downsample conv), and Adam's
# first step, g / (|g| + 1e-8), turns its relative error into an update
# error of order one; such elements are held to the +-LR bound.
NOISE_FLOOR = {"S": 0.0, "CD": 1e-5, "CD2": 1e-5, "micro": 1e-5}
LR = 0.1
WD = 0.05
EMA_DECAY = 0.996
# a conv bias feeding a train-mode BatchNorm: the stem's two convs and each
# downsample's conv
BN_FED_BIAS = re.compile(r"downsample_layers\.(\d+\.0|0\.3)\.bias")
# the key part of a bias whose keys meet only other tokens' queries
KEY_BIASES = {"attn.qkv.bias": (1, 3), "attn.qkv1.bias": (1, 3),
              "attn.qkv2.bias": (1, 3), "attn.kv.bias": (0, 2)}


def _live_grad(name, t):
    """Mask of the elements whose exact gradient is not structurally zero.
    Zero are: a conv bias feeding a train-mode BatchNorm (the batch mean is
    subtracted) and the key part of a qkv / qkv1 / qkv2 / kv bias (it
    shifts a query's scores alike, which softmax ignores). There the
    gradient is rounding noise in either framework and Adam's first step
    +-LR on its sign, so those elements are only held to that bound."""
    keep = np.ones(tuple(t.shape), bool)
    if BN_FED_BIAS.fullmatch(name):
        keep[:] = False
    for suffix, (part, parts) in KEY_BIASES.items():
        if name.endswith(suffix):
            w = t.shape[0] // parts
            keep[part * w:(part + 1) * w] = False
    return keep


@pytest.fixture
def kernel_path(monkeypatch):
    """Send every block that the kernels take down its kernel path on the
    CPU, where the wrappers run their plain versions."""
    monkeypatch.setattr(tmod, "use_kernel",
                        lambda backend, t: backend != "torch")


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _block_sd(tree, attn_type):
    """Port LeMeBlock state_dict from a JAX block's params."""
    def lin(p):
        return {"weight": _np(p["kernel"]).T, "bias": _np(p["bias"])}

    def ln(p):
        return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}
    parts = {
        "pos_embed": {"weight": np.transpose(
            _np(tree["pos_embed"]["dwconv"]["kernel"]), (3, 2, 0, 1)),
            "bias": _np(tree["pos_embed"]["dwconv"]["bias"])},
        "norm1": ln(tree["norm1"]), "norm2": ln(tree["norm2"]),
        "mlp.0": lin(tree["mlp"]["fc1"]), "mlp.3": lin(tree["mlp"]["fc2"])}
    for key in _ATTN_KEYS[attn_type]:
        parts[f"attn.{key}"] = lin(tree["attn"][key])
    return {f"{k}.{w}": torch.from_numpy(np.ascontiguousarray(v))
            for k, d in parts.items() for w, v in d.items()}


def _randomize(tree, rng):
    if isinstance(tree, dict):
        return {k: _randomize(v, rng) for k, v in tree.items()}
    return jnp.asarray(_np(tree) + 0.1 * rng.randn(*tree.shape))


@pytest.mark.parametrize("path", ["composed", "kernel"])
@pytest.mark.parametrize("attn_type", ["S", "C", "D", "D2"])
def test_block_train_matches_jax(monkeypatch, request, attn_type, path):
    monkeypatch.setattr(pallas_block, "_INTERPRET", True)
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, C).astype(np.float32)
    c = rng.randn(2, M, C).astype(np.float32)
    jb = JBlock(dim=C, num_heads=H, attn_type=attn_type,
                attn_backend="pallas")
    v = JBlock(dim=C, num_heads=H, attn_type=attn_type,
               attn_backend="xla").init(jax.random.PRNGKey(0),
                                        jnp.asarray(x), jnp.asarray(c))
    v = {"params": _randomize(v["params"], rng)}

    def jloss(v_, x_, c_):
        xo, co = jb.apply(v_, x_, c_, False)  # train mode
        return jnp.sum(xo ** 2) + jnp.sum(co ** 2)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        v, jnp.asarray(x), jnp.asarray(c))

    tb = tmod.LeMeBlock(C, H, attn_type).train()
    tb.load_state_dict(_block_sd(v["params"], attn_type), strict=True)
    tx = torch.tensor(x, requires_grad=True)
    tc = torch.tensor(c, requires_grad=True)
    before = dict(ft.LAUNCHES)
    xo, co = tb(tx, tc)
    loss = (xo ** 2).sum() + (co ** 2).sum()
    loss.backward()
    assert ft.LAUNCHES == before  # CPU tensors: plain phases, no launches
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    want = _block_sd(jg[0]["params"], attn_type)
    for name, p in tb.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jg[1]), **GRAD_TOL)
    np.testing.assert_allclose(tc.grad.numpy(), _np(jg[2]), **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _jax_train_step(config, frozen=(), clip=None, backend="xla"):
    """Inputs, the state before and after one JAX train step, its metrics
    and, where NOISE_FLOOR[config] is set, the gradients of its loss (as
    variables, for from_jax_params; else None), all numpy, for a micro
    model of CONFIGS at 32^2, B = 4, with the optimizer's frozen prefixes
    and clip and the model's attn_backend (its Pallas kernels run as the
    caller has set them: interpret mode, PB_TRAIN_CPE)."""
    rng = np.random.RandomState(1)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 4)
    targets = np.eye(10, dtype=np.float32)[labels] * 0.9 + 0.01
    jm = JLeMeViT(**CONFIGS[config], attn_backend=backend)
    tx = j_build_optimizer(lambda s: LR, weight_decay=WD, clip_grad=clip,
                           frozen_prefixes=frozen)
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
    grads = None
    if NOISE_FLOOR[config]:
        def loss_fn(p):  # the step's loss (no drop-path: rng unused)
            logits, _ = jm.apply({"params": p, "batch_stats": stats},
                                 jnp.asarray(x), train=True,
                                 rngs={"dropout": jax.random.PRNGKey(1)},
                                 mutable=["batch_stats"])
            return j_cross_entropy_loss(logits, jnp.asarray(targets))
        grads = to_np({"params": jax.jit(jax.grad(loss_fn))(params),
                       "batch_stats": stats})
    return (x, targets, to_np(st.variables), to_np(new.variables),
            to_np({"params": new.ema_params,
                   "batch_stats": new.batch_stats}),
            {k: float(v) for k, v in metrics.items()}, grads)


@pytest.mark.parametrize("path", ["composed", "kernel"])
@pytest.mark.parametrize("config", ["S", "CD", "CD2"])
def test_train_step_matches_jax(request, config, path):
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    check_train_step(config, _jax_train_step(config))


def check_train_step(config, jax_step, frozen=(), clip=None, **model_kw):
    """One port train step of CONFIGS[config] (LeMeViT(**model_kw)) against
    ``jax_step`` (_jax_train_step's output for the same config, frozen
    prefixes and clip): loss, grad norm, every parameter's update and the
    EMA's, the BatchNorm running statistics. Returns the port's metrics."""
    x, targets, v0, v1, ema1, jmetrics, jgrads = jax_step
    tm = tmod.LeMeViT(**CONFIGS[config], **model_kw)
    sd0 = from_jax_params(v0, tm)
    tm.load_state_dict(sd0, strict=True)
    floor = NOISE_FLOOR[config]
    if clip:
        # Adam sees the gradients scaled by the clip, closer to its eps by
        # that factor: the floor rises by it
        floor /= min(1.0, clip / jmetrics["grad_norm"])
    # the noise floor is read off the reference's gradients, so that the
    # port's own cannot exempt an element
    grads = from_jax_params(jgrads, tm) if floor else {}
    state = TrainState(tm, build_optimizer(tm, weight_decay=WD,
                                           frozen_prefixes=frozen),
                       lambda u: LR, ModelEma(tm, EMA_DECAY), clip_grad=clip)
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
            if name in grads:
                g = grads[name].abs()
                keep &= (g >= floor * g.max()).numpy()
            for tag, new, ref, scale in (
                    ("", t, want[name], LR),
                    ("ema ", state.ema.params[name], want_ema[name],
                     (1 - EMA_DECAY) * LR)):
                got_u = ((new - sd0[name]) / scale).numpy()
                want_u = ((ref - sd0[name]) / scale).numpy()
                np.testing.assert_allclose(got_u[keep], want_u[keep],
                                           **GRAD_TOL, err_msg=tag + name)
                # +-1, and AdamW's decoupled decay WD |p| where the noise
                # floor masks an element of a decayed weight
                bound = 1 + 1e-4 + (WD * np.abs(sd0[name].numpy()) if floor
                                    else 0)
                assert (np.abs(got_u) <= bound)[~keep].all()
        else:  # BatchNorm running statistics
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       **GRAD_TOL, err_msg=name)
    return metrics


# ---------------------------------------------------------------- repairs


@pytest.mark.parametrize("path", ["composed", "kernel"])
def test_grad_norm_and_clip_cover_frozen_params(request, path):
    """With a frozen head and clip_grad 1.0, the reported norm and the clip
    are over every parameter's gradient, as JAX's optax_global_norm(grads)
    and its clip_by_global_norm before the freeze mask: lemevit_micro at
    32^2 against JAX's build_optimizer(frozen_prefixes=("head",),
    clip_grad=1.0) step. The head's parameters stay as they were."""
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    frozen, clip = ("head",), 1.0
    jstep = _jax_train_step("micro", frozen, clip)
    assert jstep[5]["grad_norm"] > clip  # the clip is active
    metrics = check_train_step("micro", jstep, frozen, clip)
    # the norm of the frozen head's gradient is part of the reported one
    unfrozen = _jax_train_step("micro", (), clip)[5]["grad_norm"]
    np.testing.assert_allclose(metrics["grad_norm"].item(), unfrozen,
                               rtol=5e-3)
    v0, v1 = jstep[2]["params"]["head"], jstep[3]["params"]["head"]
    np.testing.assert_array_equal(v0["kernel"], v1["kernel"])


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
    c = torch.zeros(1, 16, 32)
    assert s._fusable(x1024, c) and not s._fusable(x3136, c)
    assert d._fusable(x3136, c) and not d._fusable(
        torch.zeros(1, 1, 3137, 32), c)
    assert tmod.kernel_takes("S", 784) and not tmod.kernel_takes("S", 3136)


@pytest.mark.parametrize("attn_type", ["C", "D", "D2"])
def test_cd_blocks_train_on_kernel_path(kernel_path, attn_type):
    """A train-mode C / D / D2 block where its training kernels run: no
    raise, the shapes and gradients of both streams, the C block's x passed
    through, and on CPU tensors the plain phases (no launch counted)."""
    blk = tmod.LeMeBlock(32, 1, attn_type, drop_path=0.3).train()
    blk.drop_path.generator = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 4, 32, requires_grad=True)
    c = torch.randn(2, 8, 32, requires_grad=True)
    assert blk._fusable(x, c, train=True)
    before = dict(ft.LAUNCHES)
    xo, co = blk(x, c)
    assert xo.shape == x.shape and co.shape == c.shape
    assert (xo is x) == (attn_type == "C")
    (xo.square().sum() + co.square().sum()).backward()
    assert ft.LAUNCHES == before
    assert x.grad.shape == x.shape and c.grad.abs().sum() > 0
    assert all(p.grad is not None for p in blk.parameters())


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
