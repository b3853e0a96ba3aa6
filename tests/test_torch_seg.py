"""PyTorch port, segmentation (tasks/upernet.py, cli/train_seg.py) on the
CPU against the JAX package:
  - a micro UperNet (LeMeViT backbone with 16 meta tokens, 64 px, 16 head
    channels) with every block forced onto the module path in both
    packages (JAX: PB_MAX_FUSED_N=0 and the Pallas attention kernels in
    interpret mode; port: the block kernels' token limits at 0 and
    use_kernel forced for CPU tensors, so the modules reach attn/dca.py
    and attn/mhsa.py), the same numpy-seeded weights moved by
    models/convert.py::from_jax_upernet: eval logits and aux logits at
    2e-4; one training loss (CE + 0.4 aux CE, batch-statistics BatchNorm)
    at 2e-4, its gradients at 5e-3 and the updated BatchNorm statistics
    at 2e-4 (ROADMAP "How each slice is held");
  - resize and adaptive_avg_pool, up and down; slide_inference over
    several windows; warmup_poly_schedule; seg_metrics; the loss;
  - the loaders' collate_fn and a train_seg --synthetic --device cpu run.
All fp32."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import pallas_dca, pallas_mhsa
from lemevit_tpu.cli.train_seg import seg_metrics as j_seg_metrics
from lemevit_tpu.models import LeMeViT as JLeMeViT
from lemevit_tpu.tasks import upernet as jup
from lemevit_tpu.train.optim import warmup_poly_schedule as j_poly
from lemevit_tpu_torch.attn import dca as tdca
from lemevit_tpu_torch.attn import mhsa as tmhsa
from lemevit_tpu_torch.attn import modules as tmodules
from lemevit_tpu_torch.cli import train_seg
from lemevit_tpu_torch.data.loader import Loader, create_loader
from lemevit_tpu_torch.models import lemevit as tmod
from lemevit_tpu_torch.models.convert import from_jax_upernet
from lemevit_tpu_torch.tasks import upernet as tup
from lemevit_tpu_torch.train.optim import warmup_poly_schedule

CFG = dict(depth=(1, 1, 1, 1, 1), embed_dim=(16, 16, 32, 32, 32),
           head_dim=8, mlp_ratios=(2, 2, 2, 2, 2),
           attn_type=("C", "D", "D", "S", "S"), queries_len=16)
NC, CH, IMG, B = 5, 16, 64, 2
OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)


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
        else:
            a = 0.1 * rng.randn(*v.shape)
        out[k] = np.asarray(a, np.float32)
    return out


@pytest.fixture(scope="module")
def jax_variables():
    """Random JAX UperNet variables, numpy-seeded on the shapes of its
    init (traced on the "xla" backend, without running it)."""
    jm = jup.UperNet(backbone=JLeMeViT(**CFG, features_only=True,
                                       attn_backend="xla"),
                     num_classes=NC, channels=CH)
    v = jax.eval_shape(functools.partial(jm.init, with_aux=True),
                       jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.RandomState(0)
    return {"params": _randomize(v["params"], rng),
            "batch_stats": _randomize(v["batch_stats"], rng, True)}


@pytest.fixture
def module_path(monkeypatch):
    """Every block composes in both packages and its attention module
    calls the attention-only kernel functions; returns the port's call
    counts of those functions."""
    monkeypatch.setenv("PB_MAX_FUSED_N", "0")
    monkeypatch.setattr(pallas_dca, "_INTERPRET", True)
    monkeypatch.setattr(pallas_mhsa, "_INTERPRET", True)
    monkeypatch.setattr(tmod, "MAX_N_BLOCK_KERNEL", 0)
    monkeypatch.setattr(tmod, "MAX_N_S_KERNEL", 0)
    monkeypatch.setattr(tmodules, "use_kernel",
                        lambda backend, t: backend != "torch")
    calls = {"dca": 0, "mhsa": 0}
    for mod, name in ((tdca, "dca"), (tmhsa, "mhsa")):
        def spy(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


def _models(variables):
    jm = jup.UperNet(backbone=JLeMeViT(**CFG, features_only=True,
                                       attn_backend="pallas"),
                     num_classes=NC, channels=CH)
    tm = tup.UperNet(tmod.LeMeViT(**CFG, features_only=True), NC, CH)
    tm.load_state_dict(from_jax_upernet(variables, tm), strict=True)
    return jm, tm


def _images(seed=0, b=B):
    return np.random.RandomState(seed).randn(b, IMG, IMG, 3).astype(
        np.float32)


def test_upernet_eval_matches_jax(jax_variables, module_path):
    jm, tm = _models(jax_variables)
    x = _images()
    want = jax.jit(functools.partial(jm.apply, with_aux=True))(
        jax_variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), with_aux=True)
    # stages 1-2 reach dca, stages 3-4 mhsa on both streams
    assert module_path == {"dca": 2, "mhsa": 4}
    for g, w in zip(got, want):
        assert g.shape == (B, IMG, IMG, NC) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OUT_TOL)


def test_upernet_train_loss_and_grads_match_jax(jax_variables, module_path):
    jm, tm = _models(jax_variables)
    x = _images(1)
    mask = np.random.RandomState(2).randint(0, NC, (B, IMG, IMG))

    def ce(lg):
        logp = jax.nn.log_softmax(lg.astype(jnp.float32), -1)
        return -(jax.nn.one_hot(mask, NC) * logp).sum(-1).mean()

    def loss_fn(params):
        (logits, aux), mut = jm.apply(
            {"params": params, "batch_stats": jax_variables["batch_stats"]},
            jnp.asarray(x), train=True, with_aux=True,
            mutable=["batch_stats"])
        return ce(logits) + 0.4 * ce(aux), mut

    (j_loss, mut), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax_variables["params"])
    tm.train()
    logits, aux = tm(torch.from_numpy(x), with_aux=True)
    tmask = torch.from_numpy(mask)
    loss = (train_seg.seg_loss(logits, tmask)
            + 0.4 * train_seg.seg_loss(aux, tmask))
    loss.backward()
    assert module_path == {"dca": 2, "mhsa": 4}
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    want = from_jax_upernet(
        {"params": jax.tree_util.tree_map(np.asarray, j_grads),
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               mut["batch_stats"])}, tm)
    for name, p in tm.named_parameters():
        # the meta tokens past stage 2 reach no output: no gradient here,
        # zeros under jax.grad
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, buf in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       err_msg=name, **OUT_TOL)


@pytest.mark.parametrize("src,dst", [((6, 6), (2, 2)), ((5, 5), (3, 3)),
                                     ((2, 2), (8, 8)), ((16, 16), (64, 64)),
                                     ((6, 2), (2, 8)), ((4, 4), (4, 4))])
def test_resize_matches_jax(src, dst):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    want = jup.resize(jnp.asarray(x), dst)
    got = tup.resize(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("src,dst", [((2, 2), (6, 6)), ((7, 5), (3, 2)),
                                     ((16, 16), (6, 6)), ((3, 3), (1, 1))])
def test_adaptive_avg_pool_matches_jax(src, dst):
    x = np.random.RandomState(1).randn(2, *src, 4).astype(np.float32)
    want = jup.adaptive_avg_pool(jnp.asarray(x), dst)
    got = tup.adaptive_avg_pool(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if src[0] % dst[0] == 0 and src[1] % dst[1] == 0:  # torch's own pool
        ref = torch.nn.functional.adaptive_avg_pool2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_slide_inference_matches_jax():
    """64 px images, 48 px crops at stride 32: windows at 0 and 16 per
    side (the extra flush row and column), 4 in all, overlapping."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    w = rng.randn(3, NC).astype(np.float32)
    seen = []

    def fn_jax(crop):
        seen.append(crop.shape)
        return jnp.tanh(crop @ w) * crop.mean(axis=(1, 2, 3), keepdims=True)

    def fn_torch(crop):
        return (torch.tanh(crop @ torch.from_numpy(w))
                * crop.mean(dim=(1, 2, 3), keepdim=True))

    want = jup.slide_inference(fn_jax, jnp.asarray(x), NC, crop_size=48,
                               stride=32)
    got = tup.slide_inference(fn_torch, torch.from_numpy(x), NC,
                              crop_size=48, stride=32)
    assert len(seen) == 4 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"min_lr": 1e-5, "power": 0.9,
                                     "warmup_iters": 10}])
def test_warmup_poly_schedule_matches_jax(kw):
    """The JAX schedule runs in float32, where the warmup's 1 - (1 - s/w)
    (1 - 1e-6) cancels (at s = 0 it gives 1.013e-6 for 1e-6); the port's
    runs in float64, as mmcv's. They agree to float32 rounding of the
    O(1) factors times the base LR (4e-4 * 2^-23 ~ 5e-11, four ulps)."""
    sj = j_poly(4e-4, 80000, **kw)
    st = warmup_poly_schedule(4e-4, 80000, **kw)
    for step in (0, 1, 1499, 1500, 80000):
        np.testing.assert_allclose(st(step), float(sj(step)), rtol=1e-6,
                                   atol=2e-10)
    if not kw:  # mmcv's values: 1e-6 of the LR at 0, no offset at 1500
        assert st(0) == pytest.approx(4e-10, rel=1e-12)
        assert st(1500) == pytest.approx(4e-4 * (1 - 1500 / 80000),
                                         rel=1e-12)
        assert st(80000) == 0.0


def test_seg_metrics_match_jax():
    conf = np.random.RandomState(4).randint(0, 50, (6, 6))
    conf[3] = 0  # a class with no ground truth
    assert train_seg.seg_metrics(conf) == pytest.approx(j_seg_metrics(conf))


@pytest.mark.parametrize("ignore", [None, 2])
def test_seg_loss(ignore):
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 4, 4, NC).astype(np.float32)
    mask = rng.randint(0, NC, (2, 4, 4))
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    pix = -np.take_along_axis(logp, mask[..., None], -1)[..., 0]
    valid = np.ones_like(pix) if ignore is None else (mask != ignore)
    want = (pix * valid).sum() / max(valid.sum(), 1)
    got = train_seg.seg_loss(torch.from_numpy(logits),
                             torch.from_numpy(mask), ignore)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_loaders_take_collate_fn():
    ds = train_seg._SyntheticSeg(6, 8, NC)
    (batch,) = list(Loader(ds, 4, device=torch.device("cpu"),
                           collate_fn=train_seg._collate))
    assert batch["image"].shape == (4, 8, 8, 3)
    assert batch["image"].dtype == torch.uint8
    assert batch["mask"].shape == (4, 8, 8)
    assert batch["mask"].dtype == torch.int64
    batches = list(create_loader(ds, 4, device=torch.device("cpu"),
                                 collate_fn=train_seg._collate))
    assert [b["mask"].shape[0] for b in batches] == [4, 2]
    np.testing.assert_array_equal(batches[1]["mask"][1].numpy(), ds[5][1])


def test_train_seg_cli_cpu(tmp_path):
    out = tmp_path / "seg"
    res = train_seg.main([
        "--synthetic", "--device", "cpu", "--backbone", "lemevit_micro",
        "--crop-size", "32", "--batch-size", "2", "--channels", "16",
        "--iters", "2", "--eval-interval", "2", "--output", str(out)])
    assert set(res) >= {"final_metrics", "steps", "samples_per_sec",
                        "step_ms", "peak_gib"}
    assert res["steps"] == 2 and res["peak_gib"] is None
    assert set(res["final_metrics"]) == {"mIoU", "OA", "mF1"}
    assert 0 <= res["final_metrics"]["OA"] <= 100
    assert np.isfinite(res["loss"]) and res["samples_per_sec"] > 0
    assert (out / "checkpoints" / "checkpoint-2.pth").exists()
    assert (out / "args.yaml").exists()


def test_initial_checkpoint_loads_backbone(tmp_path):
    """--initial-checkpoint: a classification checkpoint's backbone
    weights go into the features_only backbone; its head is left out."""
    from lemevit_tpu_torch import create_model
    src = create_model("lemevit_micro", device="cpu", seed=3, num_classes=7)
    torch.save({"state_dict": src.state_dict()}, tmp_path / "cls.pth")
    seg = tup.create_upernet("lemevit_micro", NC, channels=16, device="cpu")
    train_seg._load_backbone(seg.backbone, str(tmp_path / "cls.pth"))
    got = seg.backbone.state_dict()
    for k, v in src.state_dict().items():
        if k.split(".")[0] in ("norm", "norm_c", "head"):
            assert k not in got
        else:
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
