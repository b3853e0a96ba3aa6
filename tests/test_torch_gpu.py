"""PyTorch port, card-only tests: every CUDA kernel against its plain
PyTorch version, and the model's kernel paths against its plain paths.
They skip without a CUDA device. This file imports nothing of the JAX
package, so it runs on a GPU machine without flax:

  python -m pytest tests/test_torch_gpu.py -q -m gpu

Tolerances: inference blocks and attention-only kernels fp32 1e-4, bf16
3e-2 (against fp32 on the same bf16-cast inputs); training kernels (S, D,
C) the same on outputs and, on gradients, 1e-3 (fp32) and 5e-2 (bf16) of
each tensor's largest element; whole models 1e-3 (fp32 logits,
gradients)."""
import numpy as np
import pytest
import torch

import lemevit_tpu_torch
from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales

M = 16
S_TRAIN = ("s_train_fwd", "mlp_bwd", "s_attn_bwd")
PLAIN = {"c_block": fb.c_block_plain, "dca_block": fb.dca_block_plain,
         "s_block": fb.s_block_plain}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launched(before):
    """The training kernels launched since ``before`` (a LAUNCHES copy)."""
    return {k: v - before[k] for k, v in ft.LAUNCHES.items()
            if v != before[k]}


def _lin(rng, out, inp):
    return [rng.randn(out, inp) / np.sqrt(inp), 0.1 * rng.randn(out)]


def _ln(rng, ch):
    return [1 + 0.1 * rng.randn(ch), 0.1 * rng.randn(ch)]


def make_params(kind, rng, ch, hidden):
    """Parameter tuple of fused_block (torch layout), float32 numpy."""
    if kind == "c":
        p = (_ln(rng, ch) + _lin(rng, ch, ch) + _lin(rng, 2 * ch, ch)
             + _lin(rng, ch, ch))
    elif kind == "d":
        p = (_ln(rng, ch) + _lin(rng, 3 * ch, ch) + _lin(rng, 3 * ch, ch)
             + _lin(rng, ch, ch) + _lin(rng, ch, ch))
    else:
        p = _ln(rng, ch) + _lin(rng, 3 * ch, ch) + _lin(rng, ch, ch)
    p += _ln(rng, ch) + _lin(rng, hidden, ch) + _lin(rng, ch, hidden)
    return [a.astype(np.float32) for a in p]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("kind,n,ch", [("c", 3136, 96), ("d", 784, 192),
                                       ("s", 196, 384), ("s", 49, 512),
                                       ("s", 784, 192), ("s", 196, 320)])
def test_kernel_matches_plain_on_gpu(cuda, kind, n, ch, dtype, tol):
    rng = np.random.RandomState(1)
    h = ch // 32
    x = torch.from_numpy(rng.randn(2, n, ch).astype(np.float32))
    c = torch.from_numpy(rng.randn(2, M, ch).astype(np.float32))
    params = [torch.from_numpy(a) for a in make_params(kind, rng, ch, 4 * ch)]
    xd, cd = x.to(cuda, dtype), c.to(cuda, dtype)
    pd = [p.to(cuda, dtype) for p in params]
    sx, sc = dca_scales(n, M, ch)
    name = {"c": "c_block", "d": "dca_block", "s": "s_block"}[kind]

    def call(fn, *a):
        kw = {"num_heads": h}
        if kind == "d":
            kw.update(scale_x=sx, scale_c=sc)
        out = fn(*a, **kw)
        return out if isinstance(out, tuple) else (out,)

    before = fb.LAUNCHES[name]
    got = call(getattr(fb, name), xd, cd, pd)
    torch.cuda.synchronize()
    assert fb.LAUNCHES[name] == before + 1
    want = call(PLAIN[name], xd.float(), cd.float(), [p.float() for p in pd])
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.float(), w_, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_kernel_rejects_unsupported_shapes_on_gpu(cuda):
    rng = np.random.RandomState(2)
    x = torch.randn(2, 64, 64, device=cuda)
    c = torch.randn(2, M, 64, device=cuda)
    params = [torch.from_numpy(a).to(cuda)
              for a in make_params("s", rng, 64, 128)]
    with pytest.raises(ValueError, match="head_dim"):
        fb.s_block(x, c, params, num_heads=4)  # head_dim 16
    with pytest.raises(TypeError):
        fb.s_block(x.double(), c.double(), [p.double() for p in params],
                   num_heads=2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,otol,gtol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 3e-2, 5e-2)])
@pytest.mark.parametrize("n,ch", [(784, 192), (196, 320), (49, 384)])
def test_train_kernels_match_plain_on_gpu(cuda, n, ch, dtype, otol, gtol):
    """s_block_train (the three kernels under autograd) against
    s_block_train_plain, outputs and all ten gradients."""
    rng = np.random.RandomState(3)
    hid = 4 * ch
    arrays = [a.astype(np.float32) for a in (
        [rng.randn(2, n, ch), rng.randn(2, M, ch)] + _lin(rng, 3 * ch, ch)
        + _lin(rng, ch, ch) + _lin(rng, hid, ch) + _lin(rng, ch, hid))]
    dp = torch.from_numpy(((rng.rand(4, 2) < 0.7) / 0.7).astype(
        np.float32)).to(cuda)

    def run(fn, dt):
        # the fp32 reference sees the same dtype-rounded inputs
        ts = [torch.tensor(a, device=cuda, dtype=dtype).to(dt)
              .requires_grad_() for a in arrays]
        xo, co = fn(ts[0], ts[1], ts[2:], dp, num_heads=ch // 32)
        (xo.float().sum() * 0.5 + (co.float() ** 2).sum()).backward()
        return [xo.float(), co.float()] + [t.grad.float() for t in ts]

    before = dict(ft.LAUNCHES)
    got = run(ft.s_block_train, dtype)
    torch.cuda.synchronize()
    assert _launched(before) == {k: 1 for k in S_TRAIN}
    want = run(ft.s_block_train_plain, torch.float32)
    for i, (g_, w_) in enumerate(zip(got, want)):
        tol = otol if i < 2 else gtol
        scale = max(1.0, w_.abs().max().item())
        torch.testing.assert_close(g_, w_, rtol=tol, atol=tol * scale,
                                   msg=f"output/gradient {i}")


@pytest.mark.gpu
def test_model_kernel_path_matches_torch_path_on_gpu(cuda):
    m = lemevit_tpu_torch.create_model("lemevit_tiny").eval()
    x = torch.randn(2, 64, 64, 3, device="cuda")
    before = dict(fb.LAUNCHES)
    with torch.no_grad():
        got = m(x)
        m.set_attn_backend("torch")
        want = m(x)
    assert fb.LAUNCHES["c_block"] - before["c_block"] == 1
    assert fb.LAUNCHES["dca_block"] - before["dca_block"] == 4
    assert fb.LAUNCHES["s_block"] - before["s_block"] == 10
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_train_kernel_path_matches_torch_path_on_gpu(cuda):
    """vit_tiny at 64^2 (every stage within the S kernels' limit), fp32:
    loss and gradients of the training kernels against the composition."""
    kern = lemevit_tpu_torch.create_model("vit_tiny",
                                          drop_path_rate=0.2).train()
    plain = lemevit_tpu_torch.create_model("vit_tiny", drop_path_rate=0.2,
                                           attn_backend="torch").train()
    x = torch.randn(2, 64, 64, 3, device="cuda")
    before = dict(ft.LAUNCHES)
    losses = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device="cuda").manual_seed(1))
        loss = m(x).square().mean()
        loss.backward()
        losses.append(loss.item())
    assert _launched(before) == {k: 10 for k in S_TRAIN}
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for a, b in zip(kern.parameters(), plain.parameters()):
        torch.testing.assert_close(
            a.grad, b.grad, rtol=0,
            atol=1e-3 * b.grad.abs().max().item() + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,otol,gtol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 3e-2, 5e-2)])
@pytest.mark.parametrize("kind,n,ch", [("dca", 3136, 64), ("dca", 784, 128),
                                       ("c", 3136, 64)])
def test_cd_train_kernels_match_plain_on_gpu(cuda, kind, n, ch, dtype, otol,
                                             gtol):
    """dca_block_train / c_block_train (two kernels and mlp_bwd under
    autograd) against their autograd compositions at lemevit_tiny's shapes:
    the outputs and the gradients of x, c and every parameter."""
    rng = np.random.RandomState(4)
    hid = 4 * ch
    attn = ((_lin(rng, 3 * ch, ch) + _lin(rng, 3 * ch, ch)
             + _lin(rng, ch, ch) + _lin(rng, ch, ch)) if kind == "dca"
            else (_lin(rng, ch, ch) + _lin(rng, 2 * ch, ch)
                  + _lin(rng, ch, ch)))
    arrays = [a.astype(np.float32) for a in (
        [rng.randn(2, n, ch), rng.randn(2, M, ch)] + attn
        + _lin(rng, hid, ch) + _lin(rng, ch, hid))]
    dp = torch.from_numpy(((rng.rand(4, 2) < 0.7) / 0.7).astype(
        np.float32)).to(cuda)
    kw = {"num_heads": ch // 32}
    if kind == "dca":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
    fused = getattr(ft, f"{kind}_block_train")
    plain = getattr(ft, f"{kind}_block_train_plain")

    def run(fn, dt):
        ts = [torch.tensor(a, device=cuda, dtype=dtype).to(dt)
              .requires_grad_() for a in arrays]
        out = fn(ts[0], ts[1], ts[2:], dp, **kw)
        out = out if isinstance(out, tuple) else (out,)
        sum((o.float() * (i + 0.5)).square().sum() * 1e-2
            for i, o in enumerate(out)).backward()
        return [o.float() for o in out] + [t.grad.float() for t in ts]

    before = dict(ft.LAUNCHES)
    got = run(fused, dtype)
    torch.cuda.synchronize()
    assert _launched(before) == {f"{kind}_train_fwd": 1,
                                 f"{kind}_attn_bwd": 1, "mlp_bwd": 1}
    want = run(plain, torch.float32)
    n_out = 2 if kind == "dca" else 1
    assert len(got) == len(want) == n_out + len(arrays)
    for i, (g_, w_) in enumerate(zip(got, want)):
        tol = otol if i < n_out else gtol
        scale = max(1.0, w_.abs().max().item())
        torch.testing.assert_close(g_, w_, rtol=tol, atol=tol * scale,
                                   msg=f"output/gradient {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("name,launches", [
    ("lemevit_tiny", {"c_train_fwd": 1, "c_attn_bwd": 1, "dca_train_fwd": 4,
                      "dca_attn_bwd": 4, "s_train_fwd": 10, "s_attn_bwd": 10,
                      "mlp_bwd": 15}),
    ("lemevit_tiny_v2", {"c_train_fwd": 2, "c_attn_bwd": 2,
                         "dca_train_fwd": 4, "dca_attn_bwd": 4,
                         "s_train_fwd": 6, "s_attn_bwd": 6, "mlp_bwd": 12}),
])
def test_lemevit_train_kernel_path_matches_torch_path_on_gpu(cuda, name,
                                                             launches):
    """A C / D (D2) / S model at 64^2 in train mode, fp32: loss and every
    gradient of the training kernels against the composition, and each
    training kernel launched once per block."""
    kern = lemevit_tpu_torch.create_model(name, drop_path_rate=0.2).train()
    plain = lemevit_tpu_torch.create_model(name, drop_path_rate=0.2,
                                           attn_backend="torch").train()
    x = torch.randn(2, 64, 64, 3, device="cuda")
    before = dict(ft.LAUNCHES)
    losses = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device="cuda").manual_seed(1))
        loss = m(x).square().mean()
        loss.backward()
        losses.append(loss.item())
    assert _launched(before) == launches
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for a, b in zip(kern.parameters(), plain.parameters()):
        torch.testing.assert_close(
            a.grad, b.grad, rtol=0,
            atol=1e-3 * b.grad.abs().max().item() + 1e-6)


def _attn_counts():
    from lemevit_tpu_torch.attn import dca, mhsa
    return {**dca.LAUNCHES, **mhsa.LAUNCHES}


def _attn_launched(before):
    return {k: v - before[k] for k, v in _attn_counts().items()
            if v != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,ch", [(4096, 128), (1024, 64), (1000, 64)])
def test_dca_attn_matches_plain_on_gpu(cuda, n, ch, dtype, tol):
    """dca_attn on column views of projection outputs (D: leading
    dimension 3C) against dca_plain in fp32 on the same inputs; N = 1000
    leaves a ragged last key split and query block (the JAX package
    declines it, the kernel takes it)."""
    from lemevit_tpu_torch.attn import dca
    g = torch.Generator().manual_seed(7)
    lin1 = torch.randn(2, n, 3 * ch, generator=g).to(cuda, dtype)
    lin2 = torch.randn(2, M, 3 * ch, generator=g).to(cuda, dtype)
    args = (*lin1.split(ch, -1), *lin2.split(ch, -1))
    sx, sc = dca_scales(n, M, ch)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=ch // 32)
    before = _attn_counts()
    got = dca.dca_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert _attn_launched(before) == {"dca_attn": 1}
    want = dca.dca_plain(*[t.float() for t in args], **kw)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.float(), w_, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_dca_aliased_grads_on_gpu(cuda):
    """D2's dca(q, q, v1, k, k, v2) through the Function: kernel forward,
    gradients of the qv / kv projections against plain autograd."""
    from lemevit_tpu_torch.attn import dca
    g = torch.Generator().manual_seed(8)
    n, ch = 1024, 64
    lin1 = torch.randn(2, n, 2 * ch, generator=g).to(cuda).requires_grad_()
    lin2 = torch.randn(2, M, 2 * ch, generator=g).to(cuda).requires_grad_()
    sx, sc = dca_scales(n, M, ch)

    def run(fn):
        lin1.grad = lin2.grad = None
        q, v1 = lin1.split(ch, -1)
        k, v2 = lin2.split(ch, -1)
        xo, co = fn(q, q, v1, k, k, v2, scale_x=sx, scale_c=sc, num_heads=2)
        (xo.square().sum() + co.sum()).backward()
        return [xo, co, lin1.grad, lin2.grad]
    before = _attn_counts()
    got = run(dca.dca)
    assert _attn_launched(before) == {"dca_attn": 1}
    want = run(dca.dca_plain)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,ch", [(16, 96), (196, 320), (1024, 192)])
def test_mhsa_matches_plain_on_gpu(cuda, n, ch, dtype, tol):
    from lemevit_tpu_torch.attn import mhsa
    g = torch.Generator().manual_seed(9)
    qkv = torch.randn(2, n, 3 * ch, generator=g).to(cuda, dtype)
    args = qkv.split(ch, -1)
    kw = dict(scale=32 ** -0.5, num_heads=ch // 32)
    before = _attn_counts()
    got = mhsa.mhsa_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert _attn_launched(before) == {"mhsa": 1}
    want = mhsa.mhsa_plain(*[t.float() for t in args], **kw)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_attn_kernels_reject_other_head_dims_on_gpu(cuda):
    from lemevit_tpu_torch.attn import dca, mhsa
    t = torch.randn(2, 64, 64, device=cuda)
    m = torch.randn(2, M, 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        mhsa.mhsa(t, t, t, num_heads=4)  # head_dim 16: JAX takes it
    with pytest.raises(ValueError, match="head_dim"):
        dca.dca(t, t, t, m, m, m, scale_x=0.1, scale_c=0.1, num_heads=4)


@pytest.mark.gpu
def test_upernet_kernel_path_matches_torch_path_on_gpu(cuda):
    """UperNet on lemevit_tiny at 512^2, eval, fp32: the composed D blocks
    (N = 16384, 4096) on dca_attn and the S blocks on s_block, against
    the plain path."""
    from lemevit_tpu_torch.tasks.upernet import create_upernet
    m = create_upernet("lemevit_tiny", 6, channels=64).eval()
    x = torch.randn(1, 512, 512, 3, device="cuda")
    before = {**dict(fb.LAUNCHES), **_attn_counts()}
    with torch.no_grad():
        got = m(x)
        now = {**dict(fb.LAUNCHES), **_attn_counts()}
        m.backbone.set_attn_backend("torch")
        want = m(x)
    assert {k: v - before[k] for k, v in now.items() if v != before[k]} \
        == {"dca_attn": 4, "s_block": 10}
    torch.testing.assert_close(got, want, rtol=1e-3,
                               atol=1e-3 * max(1.0, want.abs().max().item()))
