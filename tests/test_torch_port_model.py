"""PyTorch port, whole model on the CPU against the JAX package's
LeMeViT(attn_backend="xla"): the same JAX-initialised weights, moved with
from_jax_params and loaded with strict=True, and the same numpy-seeded
images give the same logits and feature maps (fp32, 2e-4 as in
tests/test_torch_parity.py). Also parameter counts, metrics and
checkpoint loading."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.models import LeMeViT as JLeMeViT
from lemevit_tpu.train.steps import eval_metrics as j_eval_metrics
from lemevit_tpu_torch import create_model
from lemevit_tpu_torch.models import LeMeViT as TLeMeViT
from lemevit_tpu_torch.models.convert import from_jax_params, strip_prefixes
from lemevit_tpu_torch.models.registry import variant_config
from lemevit_tpu_torch.train.checkpoint import load_pretrained
from lemevit_tpu_torch.train.steps import eval_metrics

CFG = dict(depth=(1, 1, 1, 2, 1), embed_dim=(16, 16, 32, 32, 64),
           head_dim=8, mlp_ratios=(2, 2, 2, 2, 2),
           attn_type=("C", "D", "D", "S", "S"), queries_len=16,
           num_classes=7)
CFG_D2 = dict(CFG, depth=(1, 1, 1, 1, 1),
              attn_type=("C", "D2", "D2", "S", "S"), num_classes=5)
TOL = dict(rtol=2e-4, atol=2e-4)


def _randomize(tree, rng, stats=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, stats)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = rng.randn(*v.shape) / np.sqrt(fan_in)
        elif k in ("scale", "var"):
            out[k] = 1 + (0.4 if stats else 0.1) * rng.rand(*v.shape)
        else:
            out[k] = 0.1 * rng.randn(*v.shape)
        if not isinstance(v, dict):
            out[k] = np.asarray(out[k], np.float32)
    return out


def _jax_model_and_vars(cfg, img, features_only=False, seed=0):
    jm = JLeMeViT(**cfg, attn_backend="xla", features_only=features_only)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)))
    rng = np.random.RandomState(seed)
    return jm, {"params": _randomize(v["params"], rng),
                "batch_stats": _randomize(v["batch_stats"], rng, True)}


def _port(cfg, variables, features_only=False, **kw):
    tm = TLeMeViT(**cfg, features_only=features_only, **kw).eval()
    tm.load_state_dict(from_jax_params(variables, tm), strict=True)
    return tm


@pytest.mark.parametrize("cfg", [CFG, CFG_D2], ids=["cddss", "c_d2_d2_ss"])
def test_model_logits_match_jax(cfg):
    jm, v = _jax_model_and_vars(cfg, 32)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    tm = _port(cfg, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, cfg["num_classes"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_feature_pyramid_matches_jax():
    cfg = dict(CFG, num_classes=0)
    jm, v = _jax_model_and_vars(cfg, 32, features_only=True)
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    want = jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x))
    tm = _port(cfg, v, features_only=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,millions", [("lemevit_tiny", 8.64),
                                           ("lemevit_small", 16.40),
                                           ("lemevit_base", 53.10)])
def test_param_counts(name, millions):
    with torch.device("meta"):
        m = TLeMeViT(**variant_config(name))
    n = sum(p.numel() for p in m.parameters())
    assert round(n / 1e6, 2) == millions


def test_create_model_is_seeded():
    a = create_model("lemevit_micro", device="cpu", seed=3)
    b = create_model("lemevit_micro", device="cpu", seed=3)
    c = create_model("lemevit_micro", device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["meta_tokens"], sc["meta_tokens"])
    bf = create_model("lemevit_micro", device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


def test_eval_metrics_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(9, 10).astype(np.float32)
    labels = rng.randint(0, 10, 9).astype(np.int32)
    labels[-2:] = -1  # padding rows
    want = j_eval_metrics(jnp.asarray(logits), jnp.asarray(labels))
    got = eval_metrics(torch.from_numpy(logits),
                       torch.from_numpy(labels.astype(np.int64)))
    for k in ("loss_sum", "top1_sum", "top5_sum", "count"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_strip_prefixes():
    sd = {"model": {"module.head.weight": 1, "backbone.norm.bias": 2}}
    assert strip_prefixes(sd) == {"head.weight": 1, "norm.bias": 2}
    both = {"state_dict": {"w": "plain"}, "state_dict_ema": {"w": "ema"}}
    assert strip_prefixes(both) == {"w": "plain"}


@pytest.mark.parametrize("use_ema", [False, True])
def test_load_pretrained_roundtrip(tmp_path, use_ema):
    src = create_model("lemevit_micro", device="cpu", seed=1).eval()
    other = create_model("lemevit_micro", device="cpu", seed=2).eval()
    plain = {f"module.{k}": v for k, v in other.state_dict().items()}
    ema = {f"module.{k}": v for k, v in src.state_dict().items()}
    if use_ema:
        ckpt = {"state_dict": plain, "state_dict_ema": ema, "epoch": 3}
    else:
        ckpt = {"state_dict": ema, "epoch": 3}
    path = tmp_path / "ckpt.pth"
    torch.save(ckpt, path)
    dst = load_pretrained(create_model("lemevit_micro", device="cpu",
                                       seed=5), str(path),
                          use_ema=use_ema).eval()
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        assert torch.equal(dst(x), src(x))
    with pytest.raises(RuntimeError):  # strict: a missing key fails
        bad = dict(ckpt["state_dict"])
        bad.pop("module.head.weight")
        torch.save({"state_dict": bad}, path)
        load_pretrained(create_model("lemevit_micro", device="cpu"),
                        str(path))
