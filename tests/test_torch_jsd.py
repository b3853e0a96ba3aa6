"""PyTorch port, the AugMix / JSD recipe and freeze_bn on the CPU, against
the JAX package on the same inputs (numpy-seeded) and weights (moved by
models/convert.py):
  - jsd_cross_entropy against JAX's on random (S, B, K) logits (1e-6);
  - split BatchNorm: each split of an (S B) batch normalised with its own
    statistics and updating its own set, eval on set 0, the stack and
    unstack of the statistics;
  - one JSD step of lemevit_micro (adamw, drop-path 0, S = 3, B = 4, 32^2)
    on the composed and the kernel path against JAX's make_jsd_train_step
    from the same weights and stacked statistics: loss and gradient norm
    at 2e-4; every parameter's update at 5e-3 in units of the LR (the
    tolerance and the noise masks of tests/test_torch_train_model.py);
    each split's running mean and variance at 2e-4; then the clean-split
    eval logits against JAX's on unstack_batch_stats at 2e-4;
  - build_augsplit_transform bit for bit against JAX's under one seed;
  - freeze_bn: a train-mode forward's logits against JAX's (2e-4), the
    stem's and the downsamples' statistics unchanged, the head's equal to
    JAX's mutated ones (2e-4);
  - cli.train with --aug-splits 3 --jsd-loss on synthetic data and on a
    small JPEG folder, --opt lamb --sched plateau over two epochs with an
    eval each, and the resume of an aug-splits run with its three sets of
    statistics and its optimizer state."""
import csv
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.data import transforms as JT
from lemevit_tpu.models import LeMeViT as JLeMeViT
from lemevit_tpu.train import build_optimizer as j_build_optimizer
from lemevit_tpu.train.state import TrainState as JTrainState
from lemevit_tpu.train import steps as jsteps
from lemevit_tpu_torch.cli import train as train_cli
from lemevit_tpu_torch.core import layers as tl
from lemevit_tpu_torch.data import transforms as T
from lemevit_tpu_torch.models import lemevit as tmod
from lemevit_tpu_torch.models.convert import from_jax_params
from lemevit_tpu_torch.models.registry import create_model
from lemevit_tpu_torch.train import checkpoint as ckpt
from lemevit_tpu_torch.train.optim import build_optimizer
from lemevit_tpu_torch.train.state import ModelEma, TrainState
from lemevit_tpu_torch.train.steps import (jsd_cross_entropy, jsd_train_step,
                                           stack_batch_stats,
                                           unstack_batch_stats)
from tests.test_torch_data import jax_seeded, picture, write_folder
from tests.test_torch_train_model import (CONFIGS, EMA_DECAY, GRAD_TOL,
                                          LOSS_TOL, LR, NOISE_FLOOR, WD,
                                          _live_grad, _np, _randomize)

S, B = 3, 4
ALPHA = 12.0
STAT_TOL = dict(rtol=2e-4, atol=2e-4)
MICRO = CONFIGS["micro"]  # the registry's lemevit_micro, 10 classes
# the BatchNorms that freeze_bn keeps in eval mode: the stem's two and the
# downsamples' (lemevit_micro's stage 0 is a C stage: no downsample 1)
FROZEN_BN = ("downsample_layers.0.1", "downsample_layers.0.4",
             "downsample_layers.2.1", "downsample_layers.3.1",
             "downsample_layers.4.1")


@pytest.fixture
def kernel_path(monkeypatch):
    """Every block the kernels take goes down its kernel path on the CPU,
    where the wrappers run their plain versions."""
    monkeypatch.setattr(tmod, "use_kernel",
                        lambda backend, t: backend != "torch")


def _stats_of(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if not n.endswith("num_batches_tracked")}


# ---------------------------------------------------------------- the loss


@pytest.mark.parametrize("alpha,scale", [(12.0, 1.0), (1.0, 30.0)],
                         ids=["alpha12", "alpha1-peaked"])
def test_jsd_cross_entropy_matches_jax(alpha, scale):
    """``scale`` 30 makes some probabilities fall below the 1e-7 clip."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(S, 5, 7) * scale).astype(np.float32)
    targets = np.eye(7, dtype=np.float32)[rng.randint(0, 7, 5)] * 0.9 + 0.1 / 7
    got = jsd_cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(targets), alpha)
    want = jsteps.jsd_cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(targets), alpha)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------- split BN


def test_split_batchnorm_is_per_split():
    """In split mode a BatchNorm normalises each split with its own batch
    statistics and updates its own set (three plain BatchNorms on the three
    chunks, gradients included); eval uses set 0; leaving split mode keeps
    set 0; a channels-last input gives the same."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(S * 2, 4, 3, 5, generator=g, requires_grad=True)
    bn = tl.BatchNorm(4)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-1, 1, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    singles = [tl.BatchNorm(4) for _ in range(S)]
    for one in singles:
        one.load_state_dict(bn.state_dict())
    stack_batch_stats(bn, S)
    assert bn.running_mean.shape == (S, 4)
    y = bn(x)
    want = torch.cat([one(c) for one, c in zip(singles, x.chunk(S))])
    torch.testing.assert_close(y, want)
    gx, gw = torch.autograd.grad((y * y.detach()).sum(), (x, bn.weight))
    wx, *ws = torch.autograd.grad((want * want.detach()).sum(),
                                  [x] + [one.weight for one in singles])
    ww = sum(ws)
    torch.testing.assert_close(gx, wx)
    torch.testing.assert_close(gw, ww)
    for i, one in enumerate(singles):
        torch.testing.assert_close(bn.running_mean[i], one.running_mean)
        torch.testing.assert_close(bn.running_var[i], one.running_var)
    assert not torch.allclose(bn.running_mean[0], bn.running_mean[1])
    cl = x.detach().contiguous(memory_format=torch.channels_last)
    bn2 = tl.BatchNorm(4)
    bn2.load_state_dict(singles[0].state_dict())
    stack_batch_stats(bn2, S)
    torch.testing.assert_close(bn2(cl), want.detach())
    bn.eval()
    singles[0].eval()
    torch.testing.assert_close(bn(x[:2]), singles[0](x[:2]))
    unstack_batch_stats(bn)
    assert bn.running_mean.shape == (4,)
    torch.testing.assert_close(bn.running_mean, singles[0].running_mean)


# ---------------------------------------------------------------- JSD step


@functools.lru_cache(maxsize=None)
def _jax_jsd_step():
    """Inputs, the variables before (stacked statistics) and after one JAX
    JSD step of lemevit_micro, its metrics, its loss's gradients (for the
    noise floor), and the clean-split eval logits after the step."""
    rng = np.random.RandomState(5)
    images = rng.rand(S, B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, B)
    targets = np.eye(10, dtype=np.float32)[labels] * 0.9 + 0.01
    jm = JLeMeViT(**MICRO, attn_backend="xla")
    tx = j_build_optimizer(lambda s: LR, weight_decay=WD)
    # create_train_state's fields, with the init under jit (eager flax
    # init takes half a minute on the CPU)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))
    stats = jax.tree.map(
        lambda a: jnp.asarray(_np(a) + 0.5 * rng.rand(*a.shape)),
        v["batch_stats"])
    params = _randomize(v["params"], rng)
    st = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=jsteps.stack_batch_stats(stats, S),
                     opt_state=tx.init(params),
                     ema_params=jax.tree.map(jnp.copy, params),
                     ema_decay=EMA_DECAY, apply_fn=jm.apply, tx=tx)
    step = jax.jit(jsteps.make_jsd_train_step(S, jsd_alpha=ALPHA))
    new, metrics = step(st, {"image": jnp.asarray(images),
                             "label": jnp.asarray(targets)},
                        jax.random.PRNGKey(1))

    def loss_fn(p):
        def one(bs, im):
            out, _ = jm.apply({"params": p, "batch_stats": bs}, im,
                              train=True, mutable=["batch_stats"])
            return out
        logits = jax.vmap(one)(st.batch_stats, jnp.asarray(images))
        return jsteps.jsd_cross_entropy(logits, jnp.asarray(targets), ALPHA)

    grads = jax.jit(jax.grad(loss_fn))(params)
    eval_logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": new.params,
         "batch_stats": jsteps.unstack_batch_stats(new.batch_stats)},
        jnp.asarray(images[0]))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (images, targets, to_np(st.variables), to_np(new.variables),
            {k: float(v) for k, v in metrics.items()},
            to_np({"params": grads, "batch_stats": stats}),
            np.asarray(eval_logits))


@pytest.mark.parametrize("path", ["composed", "kernel"])
def test_jsd_step_matches_jax(request, path):
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    images, targets, v0, v1, jmetrics, jgrads, jeval = _jax_jsd_step()
    tm = tmod.LeMeViT(**MICRO)
    stack_batch_stats(tm, S)
    sd0 = from_jax_params(v0, tm)
    tm.load_state_dict(sd0, strict=True)
    state = TrainState(tm, build_optimizer(tm, weight_decay=WD),
                       lambda u: LR, ModelEma(tm, EMA_DECAY))
    metrics = jsd_train_step(state, torch.from_numpy(images),
                             torch.from_numpy(targets), ALPHA)
    np.testing.assert_allclose(metrics["loss"].item(), jmetrics["loss"],
                               **LOSS_TOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               jmetrics["grad_norm"], **LOSS_TOL)
    want = from_jax_params(v1, tm)
    grads = from_jax_params(jgrads, tm)
    floor = NOISE_FLOOR["micro"]
    params = dict(tm.named_parameters())
    n_stats = 0
    for name, t in tm.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name in params:
            # the update in units of the LR (Adam's first step is ~ +-LR);
            # elements whose gradient is structurally zero or within fp32
            # rounding of it only to the +-LR (and decoupled decay) bound
            keep = _live_grad(name, t)
            g = grads[name].abs()
            keep &= (g >= floor * g.max()).numpy()
            got_u = ((t - sd0[name]) / LR).numpy()
            want_u = ((want[name] - sd0[name]) / LR).numpy()
            np.testing.assert_allclose(got_u[keep], want_u[keep],
                                       **GRAD_TOL, err_msg=name)
            bound = 1 + 1e-4 + WD * np.abs(sd0[name].numpy())
            assert (np.abs(got_u) <= bound)[~keep].all(), name
        else:  # (S, C) running statistics, one set per split
            assert t.shape[0] == S, name
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       **STAT_TOL, err_msg=name)
            n_stats += 1
    assert n_stats == 12  # mean and variance of 6 BatchNorms
    # the splits saw different views: their statistics parted
    assert not torch.allclose(tm.norm.running_mean[0],
                              tm.norm.running_mean[1])
    # eval on the clean split's set, with JAX's updated variables (Adam
    # moves a noise-level element +-LR on its sign, so the two steps'
    # weights differ there)
    tm.load_state_dict(want, strict=True)
    tm.eval()
    with torch.no_grad():
        logits = tm(torch.from_numpy(images[0]))
    np.testing.assert_allclose(logits.numpy(), jeval, **STAT_TOL)


def test_jsd_step_needs_split_mode():
    tm = tmod.LeMeViT(**MICRO)
    state = TrainState(tm, build_optimizer(tm), lambda u: LR)
    with pytest.raises(ValueError, match="stack_batch_stats"):
        jsd_train_step(state, torch.zeros(S, 2, 32, 32, 3),
                       torch.full((2, 10), 0.1))


# ---------------------------------------------------------------- the data


@pytest.mark.parametrize("aa,splits,hflip", [("augmix-m3-w3", 3, 0.5),
                                             ("augmix-m5-w2-d2", 2, 1.0)],
                         ids=["m3-w3-s3", "m5-w2-d2-s2"])
def test_augsplit_transform_bit_for_bit(aa, splits, hflip):
    """One crop and flip per sample, split 0 clean, the rest through
    AugMix, drawing in JAX's order: the same bits under the same seed."""
    j = JT.build_augsplit_transform(28, hflip=hflip, auto_augment=aa,
                                    num_splits=splits)
    t = T.build_augsplit_transform(28, hflip=hflip, auto_augment=aa,
                                   num_splits=splits)
    img = picture(45, 61, seed=11)
    for s in range(6):
        got = t(img, T.Rng.from_seed(s))
        assert got.shape == (splits, 28, 28, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_seeded(s, j, img))
        assert not np.array_equal(got[0], got[1])  # split 1 is augmented


# ---------------------------------------------------------------- freeze_bn


@pytest.mark.parametrize("path", ["composed", "kernel"])
def test_freeze_bn_matches_jax(request, path):
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    rng = np.random.RandomState(7)
    x = rng.rand(B, 32, 32, 3).astype(np.float32)
    jm = JLeMeViT(**MICRO, attn_backend="xla", freeze_bn=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))
    v = {"params": _randomize(v["params"], rng),
         "batch_stats": jax.tree.map(
             lambda a: jnp.asarray(_np(a) + 0.5 * rng.rand(*a.shape)),
             v["batch_stats"])}
    logits, mutated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tm = create_model("lemevit_micro", num_classes=10, device="cpu",
                           freeze_bn=True)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, v), tm))
    before = _stats_of(tm)
    tm.train()
    assert tm.training and tm.norm.training
    assert not tm.downsample_layers[0][1].training
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               **STAT_TOL)
    out.sum().backward()  # the frozen BNs' affine parameters still learn
    assert tm.downsample_layers[0][1].weight.grad.abs().max() > 0
    after = _stats_of(tm)
    want = from_jax_params({"params": jax.tree.map(np.asarray, v["params"]),
                            "batch_stats": jax.tree.map(
                                np.asarray, mutated["batch_stats"])}, tm)
    for name in after:
        if name.rsplit(".", 1)[0] in FROZEN_BN:
            assert torch.equal(after[name], before[name]), name
        np.testing.assert_allclose(after[name].numpy(), want[name].numpy(),
                                   **STAT_TOL, err_msg=name)
    assert not torch.equal(after["norm.running_mean"],
                           before["norm.running_mean"])


# ---------------------------------------------------------------- the CLI


def _run(tmp_path, epochs, *extra):
    return train_cli.main([
        "--model", "lemevit_micro", "--img-size", "32", "--batch-size", "2",
        "--num-classes", "3", "--device", "cpu", "--epochs", str(epochs),
        "--steps-per-epoch", "2", "--output", str(tmp_path),
        "--log-interval", "1", "--warmup-epochs", "1",
        "--checkpoint-hist", "1", "--workers", "1", *extra])


def _checkpoint(tmp_path):
    return torch.load(ckpt.latest_checkpoint(
        str(tmp_path / "lemevit_micro" / "checkpoints")), weights_only=True)


def test_train_cli_aug_splits_resumes(tmp_path):
    """--aug-splits 3 --jsd-loss on synthetic data: two steps; the
    checkpoint holds three sets of every BatchNorm's statistics; a longer
    run resumes from it with those sets and the optimizer's state."""
    splits = ["--synthetic", "--aug-splits", "3", "--jsd-loss"]
    res = _run(tmp_path, 1, *splits)
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    assert res["views_per_sec"] == 3 * res["samples_per_sec"]
    saved = _checkpoint(tmp_path)
    assert saved["state_dict"]["norm.running_mean"].shape == (3, 32)
    # resume into a fresh split-mode state as the CLI builds it
    tm = tmod.LeMeViT(**dict(MICRO, num_classes=3))
    stack_batch_stats(tm, 3)
    st = TrainState(tm, build_optimizer(tm), lambda u: LR, ModelEma(tm, 0.9))
    st, resumed = ckpt.auto_resume(
        str(tmp_path / "lemevit_micro" / "checkpoints"), st)
    assert resumed and st.step == 2
    for name, t in tm.state_dict().items():
        torch.testing.assert_close(t, saved["state_dict"][name], rtol=0,
                                   atol=0)
    got = st.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        torch.testing.assert_close(got[i]["exp_avg"], s["exp_avg"], rtol=0,
                                   atol=0)
    res = _run(tmp_path, 2, *splits)
    assert res["steps"] == 4
    log = (tmp_path / "lemevit_micro" / "train.log").read_text()
    assert "auto-resumed at step 2" in log and "disabling mixup" in log


def test_train_cli_aug_splits_on_jpegs(tmp_path):
    """The AugMix split transform on real images through the loader."""
    data = tmp_path / "data"
    for split in ("train", "validation"):
        write_folder(str(data / split), per_class=2, seed=len(split))
    res = _run(tmp_path / "out", 1, "--dataset", "imagefolder",
               "--data-dir", str(data), "--aug-splits", "3", "--jsd-loss",
               "--aa", "augmix-m3-w3")
    assert res["steps"] == 2 and np.isfinite(res["train_loss"])
    assert res["best_top1"] >= 0


def test_train_cli_lamb_plateau(tmp_path):
    """--opt lamb --sched plateau over two epochs, an eval each: the
    controller is fed the eval metric and the checkpoint holds its
    scale."""
    res = _run(tmp_path, 2, "--synthetic", "--opt", "lamb", "--sched",
               "plateau", "--patience-epochs", "0", "--decay-rate", "0.5",
               "--checkpoint-hist", "2")
    assert res["steps"] == 4 and np.isfinite(res["train_loss"])
    with open(tmp_path / "lemevit_micro" / "summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert all(r["top1"] != "" for r in rows)
    groups = _checkpoint(tmp_path)["optimizer"]["param_groups"]
    assert {g["plateau_scale"] for g in groups} == {res["plateau_scale"]}
    assert res["plateau_scale"] in (1.0, 0.5)
    assert os.path.exists(tmp_path / "lemevit_micro" / "events.jsonl")
