"""PyTorch port, change detection on the CPU against the JAX package:
  - ResNet18 / 50 and Swin-tiny pyramids (models/resnet.py,
    models/swin.py; Swin at window 4 on 24 px, where the windows shrink,
    pad and shift, and at its window 7 on 56 px), eval and train mode,
    from numpy-seeded JAX variables moved by models/convert.py: 2e-4;
  - BIT (tasks/change_detection.py) on lemevit_micro (dec_depth 1) and on
    resnet18, and the SNUNet heads (tasks/snunet.py) in eval mode:
    logits 2e-4 (from_jax_cd, load_state_dict strict);
  - every loss of ops/losses.py at 1e-6;
  - cli.train_cd's _collate on CDPairDataset samples of a PNG folder the
    test writes, against JAX's;
  - one cli.train_cd step (BIT, ce and hybrid) from the same weights
    against JAX's train_step (model.apply with mutable batch statistics,
    optax.adamw at weight decay 0.01 on a linear schedule): loss 2e-4,
    parameters and BatchNorm statistics 5e-3;
  - cli.train_cd --synthetic on the CPU for each head, --eval-only,
    cli.visualize_cd, and prf1.
All fp32."""
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lemevit_tpu.cli import train_cd as j_train_cd
from lemevit_tpu.data import datasets as JD
from lemevit_tpu.models import create_model as j_create_model
from lemevit_tpu.ops import losses as JL
from lemevit_tpu.tasks import change_detection as jcd
from lemevit_tpu.tasks import snunet as jsn
from lemevit_tpu_torch.cli import train_cd, visualize_cd
from lemevit_tpu_torch.core.layers import set_generator
from lemevit_tpu_torch.data import datasets as D
from lemevit_tpu_torch.models.convert import from_jax_backbone, from_jax_cd
from lemevit_tpu_torch.models import resnet as tresnet
from lemevit_tpu_torch.models import swin as tswin
from lemevit_tpu_torch.models.registry import create_model
from lemevit_tpu_torch.ops import losses as L
from lemevit_tpu_torch.tasks import (BITChangeDetector, SiamNestedUNetConc,
                                     SiamUnetDiff, SNUNetECAM)

OUT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these micro sizes: with several test
    workers on the machine, a pool per worker as wide as the machine
    spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
PARAM_TOL = dict(rtol=5e-3, atol=5e-3)


def _randomize(tree, rng, stats=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, stats)
            continue
        if k == "kernel":
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif k in ("scale", "var"):
            a = 1 + (0.4 if stats else 0.1) * rng.rand(*v.shape)
        elif k == "meta_tokens":
            a = rng.randn(*v.shape)
        else:
            a = 0.1 * rng.randn(*v.shape)
        out[k] = np.asarray(a, np.float32)
    return out


def jax_variables(model, *inputs, seed=0):
    """numpy-seeded variables on the shapes of ``model``'s init (traced,
    not run)."""
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                       *[jnp.zeros(x.shape) for x in inputs])
    rng = np.random.RandomState(seed)
    out = {"params": _randomize(v["params"], rng)}
    if "batch_stats" in v:
        out["batch_stats"] = _randomize(v["batch_stats"], rng, True)
    return out


def images(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def tt(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol=OUT_TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if
                                          torch.is_tensor(got) else got),
                               np.asarray(want), **tol)


# ---------------------------------------------------------------- backbones

BACKBONES = {
    "resnet18-64": ("resnet18", 64, {}),
    "resnet50-32": ("resnet50", 32, {}),
    "swin_w4-24": ("swin_tiny", 24, {"window_size": 4}),
    "swin-56": ("swin_tiny", 56, {}),
}


@pytest.mark.parametrize("case", list(BACKBONES))
def test_backbone_pyramid_matches_jax(case):
    name, px, kw = BACKBONES[case]
    jm = j_create_model(name, features_only=True, **kw)
    x = images((4 if name == "resnet18" else 2, px, px, 3), seed=1)
    v = jax_variables(jm, x)
    # the factories without create_model's seeded init: the JAX weights
    # replace every parameter
    tm = (tswin.swin_tiny(img_size=px, **kw) if name.startswith("swin")
          else getattr(tresnet, name)())
    tm.load_state_dict(from_jax_backbone(v, tm), strict=True)
    tm.eval()
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = tm(tt(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w)
    if name == "resnet18":  # train mode: batch statistics and their update
        want, mut = jax.jit(functools.partial(
            jm.apply, train=True, mutable=["batch_stats"]))(v, x)
        tm.train()
        with torch.no_grad():
            got = tm(tt(x))
        for g, w in zip(got, want):
            close(g, w)
        sd = from_jax_backbone({"params": v["params"], **mut}, tm)
        for k, t in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                close(t, sd[k])


def test_swin_window_helpers_and_size_guard():
    from lemevit_tpu.models import swin as jsw
    from lemevit_tpu_torch.models import swin as tsw
    for ws in (1, 2, 4, 7):
        np.testing.assert_array_equal(tsw.rel_pos_index(ws),
                                      jsw._rel_pos_index(ws))
    x = images((2, 8, 12, 5))
    w = tsw.window_partition(tt(x), 4)
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(jsw.window_partition(x, 4)))
    np.testing.assert_array_equal(tsw.window_reverse(w, 4, 8, 12).numpy(), x)
    m = tsw.SwinTransformer(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                            num_heads=(1, 2, 4, 8), window_size=4,
                            img_size=24).eval()
    assert m(torch.zeros(1, 24, 24, 3))[0].shape == (1, 6, 6, 8)
    with pytest.raises(ValueError, match="img_size"):
        m(torch.zeros(1, 56, 56, 3))


# ---------------------------------------------------------------- heads


def _bit(backbone):
    jbb = j_create_model(backbone, features_only=True, **(
        {"attn_backend": "xla"} if backbone.startswith("lemevit") else {}))
    jm = jcd.BITChangeDetector(backbone=jbb, dec_depth=1)
    tm = BITChangeDetector(create_model(backbone, device="cpu",
                                        features_only=True), dec_depth=1)
    return jm, tm


@pytest.mark.parametrize("backbone", ["lemevit_micro", "resnet18"])
def test_bit_logits_match_jax(backbone):
    jm, tm = _bit(backbone)
    a, b = images((2, 32, 32, 3), 2), images((2, 32, 32, 3), 3)
    v = jax_variables(jm, a, b)
    tm.load_state_dict(from_jax_cd(v, tm), strict=True)
    want = jax.jit(jm.apply)(v, a, b)
    with torch.no_grad():
        got = tm.eval()(tt(a), tt(b))
    assert got.shape == want.shape == (2, 32, 32, 2)
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bit_lemevit_backbone_stops_at_the_map_it_reads(train):
    """BIT reads LeMeViT's map 2 (stage 3): stage 4's blocks never run; in
    training its downsample runs once per image, for its BatchNorm
    statistics only."""
    _, tm = _bit("lemevit_micro")
    bb = tm.backbone
    assert bb.out_indices == (1, 2, 3)
    calls = {"blocks": 0, "down": 0}
    for blk in bb.stages[4]:
        blk.register_forward_hook(
            lambda *a: calls.__setitem__("blocks", calls["blocks"] + 1))
    bb.downsample_layers[4].register_forward_hook(
        lambda *a: calls.__setitem__("down", calls["down"] + 1))
    bn = bb.downsample_layers[4][1]
    before = bn.running_mean.clone()
    a, b = images((2, 32, 32, 3), 2), images((2, 32, 32, 3), 3)
    with torch.no_grad():
        tm.train(train)(tt(a), tt(b))
    assert calls == {"blocks": 0, "down": 2 if train else 0}
    assert not torch.equal(bn.running_mean, before) == train


SNUNETS = {"snunet": (jsn.SNUNetECAM, SNUNetECAM),
           "snunet_conc": (jsn.SiamNestedUNetConc, SiamNestedUNetConc),
           "siamunet_diff": (jsn.SiamUnetDiff, SiamUnetDiff)}


@pytest.mark.parametrize("head", list(SNUNETS))
def test_snunet_heads_match_jax(head):
    jcls, tcls = SNUNETS[head]
    jm, tm = jcls(base_channels=4), tcls(base_channels=4)
    a, b = images((2, 32, 32, 3), 4), images((2, 32, 32, 3), 5)
    v = jax_variables(jm, a, b)
    tm.load_state_dict(from_jax_cd(v, tm), strict=True)
    want = jax.jit(jm.apply)(v, a, b)
    with torch.no_grad():
        got = tm.eval()(tt(a), tt(b))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == {"snunet": 1, "snunet_conc": 5,
                                     "siamunet_diff": 1}[head]
    for g, w in zip(got, want):
        close(g, w)
    if head == "snunet_conc":
        assert tm.dec0_1.conv0.weight.shape[1] == 4 * 2 + 8


def test_siamunet_diff_dropout_draws_from_its_generator():
    """core.layers.set_generator reaches SiamUnetDiff's Dropouts; the
    draws follow the generator's seed."""
    m = SiamUnetDiff(base_channels=4).train()
    a, b = torch.rand(1, 16, 16, 3), torch.rand(1, 16, 16, 3)
    with pytest.raises(RuntimeError, match="generator"):
        m(a, b)
    g = torch.Generator()
    set_generator(m, g)
    g.manual_seed(3)
    one = m(a, b)[0]
    g.manual_seed(3)
    torch.testing.assert_close(m(a, b)[0], one, rtol=0, atol=0)
    g.manual_seed(4)
    assert not torch.equal(m(a, b)[0], one)


# ---------------------------------------------------------------- losses

def _loss_inputs(seed=0, c=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, c, 6, 5).astype(np.float32) * 2
    targets = rng.randint(0, c, (2, 6, 5)).astype(np.int32)
    return logits, targets


@pytest.mark.parametrize("name,kw", [
    ("softmax_focal_loss", {}), ("softmax_focal_loss", {"gamma": 2.0}),
    ("softmax_focal_loss", {"reduction": "sum"}),
    ("softmax_focal_loss", {"reduction": "none"}),
    ("dice_loss", {}), ("jaccard_loss", {}), ("tversky_loss", {}),
    ("tversky_loss", {"alpha": 0.3, "beta": 0.7}), ("hybrid_loss", {}),
    ("hybrid_loss", {"focal_gamma": 2.0})])
def test_cd_losses_match_jax(name, kw):
    logits, targets = _loss_inputs(1)
    want = getattr(JL, name)(jnp.asarray(logits), jnp.asarray(targets), **kw)
    got = getattr(L, name)(tt(logits), tt(targets).long(), **kw)
    close(got, want, dict(rtol=1e-6, atol=1e-6))


def test_hybrid_loss_sums_over_a_tuple():
    la, t = _loss_inputs(2)
    lb, _ = _loss_inputs(3)
    want = JL.hybrid_loss((jnp.asarray(la), jnp.asarray(lb)), jnp.asarray(t))
    got = L.hybrid_loss((tt(la), tt(lb)), tt(t).long())
    close(got, want, dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_sigmoid_focal_loss_matches_jax(reduction):
    rng = np.random.RandomState(5)
    logits = rng.randn(7, 4).astype(np.float32) * 3
    targets = np.array([0, 3, -1, 2, 1, -1, 3], np.int32)
    want = JL.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                 reduction=reduction)
    got = L.sigmoid_focal_loss(tt(logits), tt(targets).long(),
                               reduction=reduction)
    close(got, want, dict(rtol=1e-6, atol=1e-6))


# ---------------------------------------------------------------- data


def write_pairs(root, split, n, px=32, seed=0):
    from PIL import Image
    rs = np.random.RandomState(seed)
    for sub in ("A", "B", "OUT"):
        os.makedirs(os.path.join(root, split, sub), exist_ok=True)
    for i in range(n):
        a = rs.randint(0, 256, (px, px, 3), np.uint8)
        b = a.copy()
        m = np.zeros((px, px), np.uint8)
        s = int(rs.randint(4, px // 2))
        b[:s, :s] = rs.randint(0, 256, (s, s, 3))
        m[:s, :s] = 255
        for sub, arr in (("A", a), ("B", b), ("OUT", m)):
            Image.fromarray(arr).save(os.path.join(root, split, sub,
                                                   f"p{i:02d}.png"))


def test_cd_pairs_collate_like_jax(tmp_path):
    write_pairs(str(tmp_path), "train", 5)
    ds, jds = (D.CDPairDataset(str(tmp_path), "train"),
               JD.CDPairDataset(str(tmp_path), "train"))
    assert ds.names == jds.names == [f"p{i:02d}.png" for i in range(5)]
    got = train_cd._collate([ds[i] for i in range(5)])
    want = j_train_cd._collate([jds[i] for i in range(5)])
    for k in ("a", "b", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert set(np.unique(got["mask"].numpy())) == {0, 1}
    syn, jsyn = train_cd._SyntheticCD(3, 16), j_train_cd._SyntheticCD(3, 16)
    for k, v in train_cd._collate([syn[i] for i in range(3)]).items():
        np.testing.assert_array_equal(
            v.numpy(), j_train_cd._collate([jsyn[i] for i in range(3)])[k])


def test_prf1():
    m = train_cd.prf1(tp=8, fp=2, fn=2)
    assert m == j_train_cd.prf1(tp=8, fp=2, fn=2)
    assert m["precision"] == pytest.approx(0.8)
    assert m["f1"] == pytest.approx(0.8)
    assert train_cd.prf1(0, 0, 0) == {"precision": 0.0, "recall": 0.0,
                                      "f1": 0.0}


# ---------------------------------------------------------------- training


LOSSES = ("ce", "hybrid")


@pytest.fixture(scope="module")
def jax_cd_steps():
    """The batch, the weights and, for each --loss, JAX's train_step
    (cli/train_cd.py:154-194, rebuilt from its parts: model.apply with
    mutable batch statistics, the CE or hybrid loss, optax.adamw at weight
    decay 0.01 on the linear schedule), jitted per loss."""
    jm, _ = _bit("lemevit_micro")
    rng = np.random.RandomState(7)
    batch = {"a": rng.randint(0, 256, (2, 32, 32, 3), np.uint8),
             "b": rng.randint(0, 256, (2, 32, 32, 3), np.uint8),
             "mask": (rng.rand(2, 32, 32) < 0.3).astype(np.int32)}
    v = jax_variables(jm, batch["a"].astype(np.float32),
                      batch["b"].astype(np.float32), seed=3)
    tx = optax.adamw(optax.linear_schedule(LR, 0.0, 10), weight_decay=0.01)

    def loss_fn(params, stats, loss):
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            batch["a"] / 255.0, batch["b"] / 255.0,
                            train=True, mutable=["batch_stats"])
        nchw = out.transpose(0, 3, 1, 2)
        if loss == "hybrid":
            value = JL.hybrid_loss([nchw], batch["mask"])
        else:
            value = JL.softmax_focal_loss(nchw, batch["mask"], gamma=0.0)
        return value, mut["batch_stats"]

    @functools.partial(jax.jit, static_argnums=2)
    def step(params, stats, loss):
        (value, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, stats, loss)
        updates, _ = tx.update(grads, tx.init(params), params)
        return value, optax.apply_updates(params, updates), new_stats

    return batch, v, lambda loss: jax.tree.map(
        np.asarray, step(v["params"], v["batch_stats"], loss))


LR = 2.4e-4


@pytest.mark.parametrize("loss", LOSSES)
def test_train_cd_step_matches_jax(jax_cd_steps, loss):
    """One step of the port's cd_train_step against JAX's train_step from
    the same weights: loss 2e-4, parameters and statistics 5e-3."""
    batch, v, jax_steps = jax_cd_steps
    j_loss, j_params, j_stats = jax_steps(loss)
    _, tm = _bit("lemevit_micro")
    tm.load_state_dict(from_jax_cd(v, tm), strict=True)
    opt = torch.optim.AdamW(tm.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.01)
    t_batch = {k: tt(x).long() if k == "mask" else tt(x)
               for k, x in batch.items()}
    got = train_cd.cd_train_step(tm, opt, LR, t_batch, loss)
    close(got, j_loss)
    want = from_jax_cd({"params": j_params, "batch_stats": j_stats}, tm)
    sd = tm.state_dict()
    assert set(sd) == set(want)
    for k, t in sd.items():
        if not k.endswith("num_batches_tracked"):
            close(t, want[k], PARAM_TOL)


CLI = ["--synthetic", "--device", "cpu", "--patch-size", "32",
       "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "2",
       "--workers", "1"]


@pytest.mark.parametrize("head,extra", [
    ("bit", ["--backbone", "lemevit_micro", "--dec-depth", "1"]),
    ("bit", ["--backbone", "resnet18", "--dec-depth", "1", "--loss",
             "hybrid"]),
    ("snunet", ["--loss", "hybrid"]),
    ("snunet_conc", ["--loss", "hybrid"]),
    ("siamunet_diff", [])],
    ids=["bit-lemevit_micro", "bit-resnet18", "snunet", "snunet_conc",
         "siamunet_diff"])
def test_train_cd_cli_cpu(tmp_path, head, extra):
    res = train_cd.main(CLI + ["--head", head, "--output", str(tmp_path)]
                        + extra)
    assert 0.0 <= res["best_f1"] <= 1.0 and np.isfinite(res["loss"])
    assert res["steps"] == 2 and res["pairs_per_sec"] > 0
    ckpts = json.load(open(tmp_path / "checkpoints" / "checkpoints.json"))
    assert len(ckpts) == 1 and os.path.exists(ckpts[0]["path"])


def test_train_cd_eval_only_and_visualize(tmp_path, capsys):
    data = tmp_path / "data"
    for split, n in (("train", 4), ("val", 3)):
        write_pairs(str(data), split, n, seed=len(split))
    args = ["--data-dir", str(data), "--device", "cpu", "--patch-size",
            "32", "--batch-size", "2", "--backbone", "lemevit_micro",
            "--workers", "1"]
    res = train_cd.main(args + ["--epochs", "1", "--output",
                                str(tmp_path / "run")])
    ckpt = json.load(open(tmp_path / "run" / "checkpoints"
                          / "checkpoints.json"))[0]["path"]
    again = train_cd.main(args + ["--eval-only", ckpt, "--output",
                                  str(tmp_path / "ev")])
    assert again["f1"] == pytest.approx(res["best_f1"])
    out = tmp_path / "vis"
    n = visualize_cd.main(["--checkpoint", ckpt, "--data-dir", str(data),
                           "--split", "val", "--backbone", "lemevit_micro",
                           "--patch-size", "32", "--device", "cpu",
                           "--out", str(out), "--limit", "2"])
    assert n == 2 and sorted(os.listdir(out)) == ["p00.png", "p01.png"]
    from PIL import Image
    m = np.asarray(Image.open(out / "p00.png"))
    assert m.shape == (32, 32) and set(np.unique(m)) <= {0, 255}


@pytest.mark.parametrize("cli", ["train_cd", "visualize_cd"])
def test_cd_clis_refuse_cpu_fallback(monkeypatch, tmp_path, cli):
    """Without --device cpu the CLIs run on the card, and raise without
    one rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--synthetic", "--output", str(tmp_path)] if cli == "train_cd"
            else ["--checkpoint", str(tmp_path / "c.pth"), "--data-dir",
                  str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"train_cd": train_cd, "visualize_cd": visualize_cd}[cli].main(argv)


def test_initial_checkpoint_goes_into_the_backbone(tmp_path):
    """--initial-checkpoint: a classification checkpoint's backbone
    weights go into BIT's backbone (its head's entries left out), on the
    CLI path too."""
    from lemevit_tpu_torch.train.checkpoint import load_backbone
    src = create_model("lemevit_micro", device="cpu", seed=3, num_classes=7)
    path = str(tmp_path / "cls.pth")
    torch.save({"state_dict": src.state_dict()}, path)
    _, tm = _bit("lemevit_micro")
    load_backbone(tm.backbone, path)
    got = tm.backbone.state_dict()
    for k, v in src.state_dict().items():
        if k.split(".")[0] in ("norm", "norm_c", "head"):
            assert k not in got
        else:
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    res = train_cd.main(CLI + ["--backbone", "lemevit_micro", "--dec-depth",
                               "1", "--initial-checkpoint", path,
                               "--output", str(tmp_path / "run")])
    assert res["steps"] == 2
