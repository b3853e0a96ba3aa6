"""PyTorch port, the training loop's pure functions and CLI on the CPU:
  - LR schedules, the loss, the weight-decay mask and one AdamW update
    against the JAX package's build_lr_schedule, cross_entropy_loss,
    _wd_mask and optax adamw (rtol 1e-5 / 1e-6: same formulas in fp32);
  - mixup / cutmix and random erasing applied on a draw taken from JAX's
    own draw code, against JAX's functions (1e-6);
  - the training loader, the flat config reader, checkpoint retention and
    resume;
  - cli.train at a micro size: summary.csv, top-k checkpoints and
    auto-resume at the saved step."""
import csv
import glob
import json
import math
import os
import re

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from lemevit_tpu.data import mixup as jmix
from lemevit_tpu.models import LeMeViT as JLeMeViT
from lemevit_tpu.train import optim as joptim
from lemevit_tpu.train.steps import cross_entropy_loss as j_ce
import lemevit_tpu_torch
from lemevit_tpu_torch.cli import train as train_cli
from lemevit_tpu_torch.data import mixup as tmix
from lemevit_tpu_torch.data.datasets import SyntheticDataset
from lemevit_tpu_torch.data.loader import Loader
from lemevit_tpu_torch.models import LeMeViT as TLeMeViT
from lemevit_tpu_torch.models.convert import from_jax_params
from lemevit_tpu_torch.train import checkpoint as ckpt
from lemevit_tpu_torch.train import optim as toptim
from lemevit_tpu_torch.train.state import ModelEma, TrainState
from lemevit_tpu_torch.train.steps import cross_entropy_loss, train_step
from lemevit_tpu_torch.utils import profiling
from lemevit_tpu_torch.utils.parser import load_flat_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = dict(depth=(1, 1, 1, 1, 1), embed_dim=(16, 16, 32, 32, 32),
             head_dim=8, mlp_ratios=(2, 2, 2, 2, 2),
             attn_type=("C", "D", "D", "S", "S"), queries_len=4,
             num_classes=5)


# ---------------------------------------------------------------- optim


@pytest.mark.parametrize("kw", [
    dict(sched="cosine"),
    dict(sched="cosine", scaling="sqrt", warmup_epochs=0),
    dict(sched="step", decay_epochs=1.5, decay_rate=0.5),
    dict(sched="multistep", decay_milestones=(1.2, 2.5, 2.6)),
    dict(sched="poly", power=2.0),
    dict(sched="constant"),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_lr_schedule_matches_jax(kw):
    args = dict(base_lr=5e-4, global_batch_size=256, steps_per_epoch=4,
                epochs=4, warmup_epochs=1, warmup_lr=1e-6, min_lr=1e-5)
    args.update(kw)
    got = toptim.build_lr_schedule(**args)
    want = joptim.build_lr_schedule(**args)
    for t in range(18):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-5,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("case", ["labels", "soft", "labels-smoothed",
                                  "soft-smoothed"])
def test_cross_entropy_matches_jax(case):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(6, 11)).astype(np.float32)
    if case.startswith("labels"):
        targets = rng.randint(0, 11, 6)
    else:
        targets = rng.dirichlet(np.ones(11), 6).astype(np.float32)
    smoothing = 0.1 if case.endswith("smoothed") else 0.0
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(targets), smoothing)
    want = j_ce(jnp.asarray(logits), jnp.asarray(targets), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_weight_decay_mask_matches_jax():
    """decays(name) for every port parameter equals the JAX package's
    _wd_mask on the same parameter, mapped through from_jax_params."""
    jm = JLeMeViT(**MICRO, attn_backend="xla")
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3)))
    mask = joptim._wd_mask(v["params"])
    as_arrays = jax.tree.map(
        lambda m, p: np.full(p.shape, float(m), np.float32), mask,
        v["params"])
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         v["batch_stats"])
    tm = TLeMeViT(**MICRO)
    want = from_jax_params({"params": as_arrays, "batch_stats": stats}, tm)
    decayed = 0
    for name, p in tm.named_parameters():
        w = want[name]
        assert torch.all(w == w.flatten()[0]), name
        assert toptim.decays(name, p) == bool(w.flatten()[0]), name
        decayed += toptim.decays(name, p)
    assert 0 < decayed < len(list(tm.parameters()))
    assert not toptim.decays("meta_tokens", tm.meta_tokens)


def test_adamw_step_matches_optax():
    """One update of the port's AdamW groups against optax.adamw with the
    JAX package's mask, with a large weight decay so that the decoupled
    decay shows."""
    rng = np.random.RandomState(0)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(5, 3)
            self.meta_tokens = torch.nn.Parameter(torch.zeros(4, 5))

    net = Net()
    vals = {"fc.weight": rng.randn(3, 5), "fc.bias": rng.randn(3),
            "meta_tokens": rng.randn(4, 5)}
    grads = {k: rng.randn(*v.shape) * 0.1 for k, v in vals.items()}
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(vals[name]))
            p.grad = torch.from_numpy(grads[name]).float()
    opt = toptim.build_optimizer(net, weight_decay=0.5)
    for group in opt.param_groups:
        group["lr"] = 0.1
    opt.step()
    jp = {"fc": {"kernel": vals["fc.weight"].T, "bias": vals["fc.bias"]},
          "meta_tokens": vals["meta_tokens"]}
    jg = {"fc": {"kernel": grads["fc.weight"].T, "bias": grads["fc.bias"]},
          "meta_tokens": grads["meta_tokens"]}
    jp, jg = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)
              for t in (jp, jg))
    tx = joptim.build_optimizer(0.1, weight_decay=0.5)
    upd, _ = tx.update(jg, tx.init(jp), jp)
    new = optax.apply_updates(jp, upd)
    got = dict(net.named_parameters())
    np.testing.assert_allclose(got["fc.weight"].detach().numpy(),
                               np.asarray(new["fc"]["kernel"]).T, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["fc.bias"].detach().numpy(),
                               np.asarray(new["fc"]["bias"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["meta_tokens"].detach().numpy(),
                               np.asarray(new["meta_tokens"]), rtol=1e-6,
                               atol=1e-6)


def test_grad_accumulation_and_clipping():
    """grad_accum_steps = 2 over two half batches updates as one step over
    the whole batch (mean gradient, as optax.MultiSteps); clip_grad scales
    the update's gradient to that global norm (optax.clip_by_global_norm)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 6, generator=g)
    y = torch.randint(0, 3, (8,), generator=g)
    init = torch.nn.Linear(6, 3).state_dict()

    def run(k, clip, make_opt, batches):
        net = torch.nn.Linear(6, 3)
        net.load_state_dict(init)
        st = TrainState(net, make_opt(net), lambda u: 0.5,
                        grad_accum_steps=k, clip_grad=clip)
        for xb, yb in batches:
            train_step(st, xb, yb)
        return net, st

    adamw = toptim.build_optimizer
    whole, st1 = run(1, None, adamw, [(x, y)])
    halves, st2 = run(2, None, adamw, [(x[:4], y[:4]), (x[4:], y[4:])])
    assert st1.updates == st2.updates == 1 and st2.step == 2
    for a, b in zip(whole.parameters(), halves.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    net, _ = run(1, 0.01, lambda n: torch.optim.SGD(n.parameters(), lr=0.0),
                 [(x, y)])
    step = torch.cat([(a - init[n]).flatten()
                      for n, a in net.named_parameters()])
    np.testing.assert_allclose(step.norm().item(), 0.5 * 0.01, rtol=1e-5)


# ---------------------------------------------------------------- mixup


def _jax_mixup_draw(rng, h, w, prob=1.0):
    """The draw inside lemevit_tpu.data.mixup.mixup_cutmix, as a port
    MixupDraw (alphas 0.8 / 1.0, switch 0.5)."""
    r_apply, r_switch, r_lam_m, r_lam_c, r_box = jax.random.split(rng, 5)
    use_aug = bool(jax.random.uniform(r_apply) < prob)
    use_cut = use_aug and bool(jax.random.uniform(r_switch) < 0.5)
    if not use_aug:
        return tmix.MixupDraw("none")
    if not use_cut:
        return tmix.MixupDraw(
            "mixup", float(jax.random.beta(r_lam_m, 0.8, 0.8)))
    lam_c = jax.random.beta(r_lam_c, 1.0, 1.0)
    ratio = jnp.sqrt(1.0 - lam_c)
    cut_h, cut_w = int((ratio * h).astype(jnp.int32)), int(
        (ratio * w).astype(jnp.int32))
    cy = int(jax.random.randint(r_box, (), 0, h))
    cx = int(jax.random.randint(jax.random.fold_in(r_box, 1), (), 0, w))
    y0, y1 = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
    x0, x1 = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
    lam = float(1.0 - jnp.asarray((y1 - y0) * (x1 - x0), jnp.int32)
                / (h * w))
    return tmix.MixupDraw("cutmix", lam, (int(y0), int(y1), int(x0),
                                          int(x1)))


@pytest.mark.parametrize("mode", ["mixup", "cutmix"])
def test_mixup_cutmix_apply_matches_jax(mode):
    h = w = 12
    rng = np.random.RandomState(0)
    images = rng.randn(6, h, w, 3).astype(np.float32)
    labels = rng.randint(0, 7, 6)
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        draw = _jax_mixup_draw(key, h, w)
        if draw.mode == mode and (mode != "cutmix" or draw.lam < 0.99):
            break
    else:
        pytest.fail(f"no {mode} draw in 64 seeds")
    wi, wt = jmix.mixup_cutmix(key, jnp.asarray(images), jnp.asarray(labels),
                               7, label_smoothing=0.1)
    gi, gt = tmix.mixup_cutmix(torch.from_numpy(images),
                               torch.from_numpy(labels), 7, draw,
                               label_smoothing=0.1)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-6,
                               atol=1e-6)


def test_random_erasing_apply_matches_jax():
    b, h, w = 8, 16, 12
    images = np.random.RandomState(1).randn(b, h, w, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    prob, scale, ratio = 0.5, (0.02, 1 / 3), (0.3, 3.3)
    # the draw inside lemevit_tpu.data.mixup.random_erasing
    rngs = jax.random.split(key, 5)
    apply = jax.random.uniform(rngs[0], (b,)) < prob
    area = jax.random.uniform(rngs[1], (b,), minval=scale[0],
                              maxval=scale[1])
    aspect = jnp.exp(jax.random.uniform(rngs[2], (b,),
                                        minval=jnp.log(ratio[0]),
                                        maxval=jnp.log(ratio[1])))
    eh = jnp.clip(jnp.sqrt(area * h * w * aspect), 1, h).astype(jnp.int32)
    ew = jnp.clip(jnp.sqrt(area * h * w / aspect), 1, w).astype(jnp.int32)
    y0 = (jax.random.uniform(rngs[3], (b,))
          * (h - eh).astype(jnp.float32)).astype(jnp.int32)
    x0 = (jax.random.uniform(jax.random.fold_in(rngs[3], 1), (b,))
          * (w - ew).astype(jnp.float32)).astype(jnp.int32)
    noise = jax.random.normal(rngs[4], images.shape, jnp.float32)
    draw = {k: torch.from_numpy(np.asarray(v)).long()
            for k, v in dict(y0=y0, x0=x0, eh=eh, ew=ew).items()}
    draw["apply"] = torch.from_numpy(np.asarray(apply))
    assert 0 < int(draw["apply"].sum()) < b
    want = jmix.random_erasing(key, jnp.asarray(images), prob=prob)
    got = tmix.random_erasing(torch.from_numpy(images), draw,
                              torch.from_numpy(np.asarray(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draws_are_seeded_and_in_range():
    for seed in range(20):
        a = tmix.draw_mixup(np.random.default_rng(seed), 16, 12)
        assert a == tmix.draw_mixup(np.random.default_rng(seed), 16, 12)
        assert a.mode in ("mixup", "cutmix") and 0 <= a.lam <= 1
        y0, y1, x0, x1 = a.box
        assert 0 <= y0 <= y1 <= 16 and 0 <= x0 <= x1 <= 12
    assert tmix.draw_mixup(np.random.default_rng(0), 8, 8,
                           prob=0.0).mode == "none"
    assert tmix.draw_mixup(np.random.default_rng(0), 8, 8, mixup_alpha=0.0
                           ).mode == "cutmix"
    d = tmix.draw_erasing(torch.Generator().manual_seed(0), 64, 16, 12)
    assert ((d["y0"] >= 0) & (d["y0"] + d["eh"] <= 16)).all()
    assert ((d["x0"] >= 0) & (d["x0"] + d["ew"] <= 12)).all()
    d2 = tmix.draw_erasing(torch.Generator().manual_seed(0), 64, 16, 12)
    assert all(torch.equal(d[k], d2[k]) for k in d)


# ---------------------------------------------------------------- data


def test_train_loader_epochs_drop_last_and_skip():
    ds = SyntheticDataset(num_samples=26, image_size=4, num_classes=50)
    loader = Loader(ds, 4, device=torch.device("cpu"), seed=3)
    assert len(loader) == 6
    full = [b["label"] for b in loader]
    assert len(full) == 6 and all(lab.shape == (4,) for lab in full)
    seen = torch.cat(full)
    assert len(set(seen.tolist())) > 1
    tail = [b["label"] for b in loader.iter_batches(4)]
    assert all(torch.equal(a, b) for a, b in zip(full[4:], tail))
    assert len(tail) == 2
    loader.set_epoch(1)
    assert not all(torch.equal(a, b["label"]) for a, b in zip(full, loader))
    it = loader.iter_batches(0)
    next(it)
    it.close()  # stops the producer thread


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yaml"))), ids=os.path.basename)
def test_flat_yaml_reader_matches_yaml(path):
    with open(path) as f:
        assert load_flat_yaml(path) == yaml.safe_load(f)


def test_flat_yaml_reader_rejects_nesting(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a: 1\nb:\n  c: 2\n")
    with pytest.raises(ValueError, match="flat"):
        load_flat_yaml(str(p))
    p.write_text("scale: [0.08, 1.0]  # RRC\nname: 'x'\nflag: true\n")
    assert load_flat_yaml(str(p)) == {"scale": [0.08, 1.0], "name": "x",
                                      "flag": True}


# ---------------------------------------------------------------- ckpt


def _state():
    m = TLeMeViT(**MICRO)
    return TrainState(m, toptim.build_optimizer(m), lambda u: 1e-3,
                      ModelEma(m, 0.9))


def test_checkpoint_top_k_and_resume(tmp_path):
    d = str(tmp_path)
    st = _state()
    for step, metric in ((1, 5.0), (2, 1.0), (3, 9.0), (4, 3.0)):
        st.step = step
        ckpt.save_checkpoint(d, st, metric=metric, max_history=2)
    kept = sorted(os.listdir(d))
    assert kept == ["checkpoint-1.pth", "checkpoint-3.pth",
                    "checkpoints.json"]
    assert ckpt.latest_checkpoint(d).endswith("checkpoint-3.pth")
    with torch.no_grad():
        st.model.meta_tokens.add_(1.0)
    st.step = 7
    ckpt.save_recovery(d, st)
    fresh, resumed = ckpt.auto_resume(d, _state())
    assert resumed and fresh.step == 7
    torch.testing.assert_close(fresh.model.meta_tokens, st.model.meta_tokens)
    torch.testing.assert_close(fresh.ema.params["meta_tokens"],
                               st.ema.params["meta_tokens"])
    assert ckpt.auto_resume(str(tmp_path / "none"), _state())[1] is False


# ---------------------------------------------------------------- CLI


def _run(tmp_path, model, epochs, *extra):
    return train_cli.main([
        "--synthetic", "--model", model, "--img-size", "32",
        "--batch-size", "2", "--num-classes", "5", "--device", "cpu",
        "--epochs", str(epochs), "--steps-per-epoch", "2",
        "--output", str(tmp_path), "--log-interval", "1",
        "--warmup-epochs", "1", "--checkpoint-hist", "1", *extra])


@pytest.mark.parametrize("model,extra", [
    ("lemevit_micro", ["--attn-backend", "torch",
                       "--config", os.path.join(REPO, "configs",
                                                "lemevit.yaml")]),
    ("vit_tiny", ["--no-model-ema"]),
])
def test_train_cli_on_cpu_resumes(tmp_path, model, extra):
    res = _run(tmp_path, model, 2, *extra)
    assert res["steps"] == 4 and math.isfinite(res["train_loss"])
    out = tmp_path / model
    with open(out / "summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == train_cli.SUMMARY_FIELDS
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert rows[0]["top1"] != "" and (rows[0]["ema_top1"] != "") == (
        "--no-model-ema" not in extra)
    with open(out / "checkpoints" / "checkpoints.json") as f:
        meta = json.load(f)
    assert len(meta) == 1 and os.path.exists(meta[0]["path"])
    assert (out / "args.yaml").exists() and (out / "events.jsonl").exists()
    res = _run(tmp_path, model, 3, *extra)  # auto-resumes at step 4
    assert res["steps"] == 6
    with open(out / "summary.csv") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["0", "1", "2"]


def test_train_cli_trains_cd_blocks_with_summary(tmp_path):
    """The C / D / S micro model trains without --attn-backend torch, and
    --summary logs the parameter table and GMACs per image."""
    res = _run(tmp_path, "lemevit_micro", 1, "--summary")
    assert res["steps"] == 2 and math.isfinite(res["train_loss"])
    log = (tmp_path / "lemevit_micro" / "train.log").read_text()
    assert "TOTAL" in log and "stages.0" in log
    gmacs = float(re.search(r"GMACs/image: (\S+)", log).group(1))
    assert gmacs > 0


def test_profiling_utilities(tmp_path):
    m = lemevit_tpu_torch.create_model("lemevit_micro", device="cpu",
                                       num_classes=10).train()
    table = profiling.model_summary(m)
    total = sum(p.numel() for p in m.parameters())
    assert "TOTAL" in table and f"{total:,}" in table
    assert "meta_tokens" in table and "stages.1" in table
    cost = profiling.cost_analysis(m, 32)
    assert cost["flops"] > 0 and cost["gmacs"] == cost["flops"] / 2e9
    assert m.training  # the mode is restored
    timer = profiling.StepTimer("cpu")
    for _ in range(2):
        timer.start()
        m(torch.zeros(2, 32, 32, 3))
        assert timer.stop() > 0
    assert len(timer.times) == 2 and timer.mean_ms > 0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        m(torch.zeros(2, 32, 32, 3))
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("conv" in e.key for e in prof.key_averages())
    info = profiling.versions()
    assert info["torch"] == torch.__version__ and "nvcc" in info
