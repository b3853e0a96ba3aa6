"""PyTorch port, card-only tests: every CUDA kernel against its plain
PyTorch version, and the model's kernel paths against its plain paths.
They skip without a CUDA device. This file imports nothing of the JAX
package, so it runs on a GPU machine without flax:

  python -m pytest tests/test_torch_gpu.py -q -m gpu

Tolerances: inference blocks (also with their in-kernel CPE), S stages and
attention-only kernels fp32 1e-4, bf16 3e-2 (against fp32 on the same
bf16-cast inputs; a bf16 stage of that of its largest element, since x is
rounded to bf16 between its blocks, and elementwise against the chain of
its S block kernels in bf16); training kernels (S, D,
C, also with the 3x3 CPE inside) the same on outputs and, on gradients
(the CPE's tap and bias gradients among them), 1e-3 (fp32) and 5e-2 (bf16)
of each tensor's largest element, the tap gradients bit for bit between two
runs; whole models 1e-3 (fp32 logits, gradients); the per-op probe within
1 bf16 step of its plain version at K = 1 and 2 at vpu_probe's K
(probes/ew.py::max_ulps), the construct probes exact (erf within 1e-6)."""
import numpy as np
import pytest
import torch

import lemevit_tpu_torch
from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales
from lemevit_tpu_torch.probes import constructs, ew

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


# the training kernels' CPE mode: lemevit_tiny's shapes and two non-square
# images, (kind, N, image width, C)
TRAIN_CPE = [("c", 3136, 56, 64), ("dca", 3136, 56, 64), ("dca", 784, 28, 128),
             ("s", 196, 14, 192), ("s", 49, 7, 320), ("s", 48, 8, 64),
             ("c", 35, 7, 64)]


def _train_cpe_case(rng, kind, n, ch, b=2):
    """x, c, taps, bias and the LN-folded parameters (float32 numpy), the
    DropPath scales on the card and the kernels' keywords of one block."""
    arrays = [rng.randn(b, n, ch), rng.randn(b, M, ch),
              0.3 * rng.randn(9, ch), 0.1 * rng.randn(ch)]
    for shape in ft._param_shapes(kind, ch, 4 * ch):
        arrays.append(rng.randn(*shape) / np.sqrt(shape[-1])
                      if len(shape) == 2 else 0.1 * rng.randn(*shape))
    dp = torch.from_numpy(((rng.rand(4, b) < 0.7) / 0.7).astype(
        np.float32)).to("cuda")
    kw = {"num_heads": ch // 32}
    if kind == "dca":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
    return [a.astype(np.float32) for a in arrays], dp, kw


def _run_train_cpe(fn, arrays, dp, kw, img_w, dtype, dt):
    """Outputs, then the gradients of x, c, the taps, the bias and every
    parameter, of fn with the CPE inside, inputs cast to ``dtype`` and run
    in ``dt``."""
    ts = [torch.tensor(a, device="cuda", dtype=dtype).to(dt)
          .requires_grad_() for a in arrays]
    out = fn(ts[0], ts[1], ts[4:], dp, cpe=ts[2:4], img_w=img_w, **kw)
    out = out if isinstance(out, tuple) else (out,)
    sum((o.float() * (i + 0.5)).square().sum() * 1e-2
        for i, o in enumerate(out)).backward()
    return [o.float() for o in out] + [t.grad.float() for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,otol,gtol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 3e-2, 5e-2)])
@pytest.mark.parametrize("kind,n,img_w,ch", TRAIN_CPE)
def test_train_cpe_kernels_match_plain_on_gpu(cuda, kind, n, img_w, ch, dtype,
                                              otol, gtol):
    """s / dca / c_block_train with cpe= (pre-CPE x, the 3x3 CPE inside the
    forward and the attention backward) against their autograd
    compositions with the same CPE: the outputs and the gradients of x, c,
    the taps, the bias and every parameter; each kernel launched once."""
    arrays, dp, kw = _train_cpe_case(np.random.RandomState(6), kind, n, ch)
    fused = getattr(ft, f"{kind}_block_train")
    plain = getattr(ft, f"{kind}_block_train_plain")
    before = dict(ft.LAUNCHES)
    got = _run_train_cpe(fused, arrays, dp, kw, img_w, dtype, dtype)
    torch.cuda.synchronize()
    assert _launched(before) == {f"{kind}_train_fwd": 1,
                                 f"{kind}_attn_bwd": 1, "mlp_bwd": 1}
    want = _run_train_cpe(plain, arrays, dp, kw, img_w, dtype, torch.float32)
    n_out = 2 if kind in ("s", "dca") else 1
    assert len(got) == len(want) == n_out + len(arrays)
    for i, (g_, w_) in enumerate(zip(got, want)):
        tol = otol if i < n_out else gtol
        scale = max(1.0, w_.abs().max().item())
        torch.testing.assert_close(g_, w_, rtol=tol, atol=tol * scale,
                                   msg=f"output/gradient {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,img_w,ch", TRAIN_CPE[:4])
def test_train_cpe_grads_are_deterministic_on_gpu(cuda, kind, n, img_w, ch):
    """Two bf16 runs of a block with its CPE inside give the same bits for
    the tap and bias gradients (fixed-order fp32 partials, no atomics)
    and for dx."""
    arrays, dp, kw = _train_cpe_case(np.random.RandomState(7), kind, n, ch,
                                     b=8)
    fused = getattr(ft, f"{kind}_block_train")
    runs = [_run_train_cpe(fused, arrays, dp, kw, img_w, torch.bfloat16,
                           torch.bfloat16) for _ in range(2)]
    n_out = 2 if kind in ("s", "dca") else 1
    for i in (n_out, n_out + 2, n_out + 3):  # dx, dtaps, dbias
        assert torch.equal(runs[0][i], runs[1][i]), i


@pytest.mark.gpu
def test_lemevit_train_cpe_kernel_path_matches_torch_path_on_gpu(cuda):
    """lemevit_tiny at 64^2 in train mode, fp32, with train_cpe_in_kernel:
    loss and every gradient (pos_embed's included) against the composition,
    each training kernel launched once per block, no block CPE convolved."""
    kern = lemevit_tpu_torch.create_model(
        "lemevit_tiny", drop_path_rate=0.2, train_cpe_in_kernel=True).train()
    plain = lemevit_tpu_torch.create_model(
        "lemevit_tiny", drop_path_rate=0.2, attn_backend="torch").train()
    convs = []
    for blk in (b for stage in kern.stages for b in stage):
        blk.pos_embed.register_forward_hook(lambda *a: convs.append(1))
    x = torch.randn(2, 64, 64, 3, device="cuda")
    before = dict(ft.LAUNCHES)
    losses = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device="cuda").manual_seed(1))
        loss = m(x).square().mean()
        loss.backward()
        losses.append(loss.item())
    assert _launched(before) == {
        "c_train_fwd": 1, "c_attn_bwd": 1, "dca_train_fwd": 4,
        "dca_attn_bwd": 4, "s_train_fwd": 10, "s_attn_bwd": 10,
        "mlp_bwd": 15}
    assert convs == []
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for (name, a), b in zip(kern.named_parameters(), plain.parameters()):
        torch.testing.assert_close(
            a.grad, b.grad, rtol=0,
            atol=1e-3 * b.grad.abs().max().item() + 1e-6, msg=name)


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


def _cpe(rng, ch, scale=0.3):
    return [(scale * rng.randn(9, ch)).astype(np.float32),
            (0.1 * rng.randn(ch)).astype(np.float32)]


def _block_call(kind, fn, x, c, params, n, ch, **kw):
    kw["num_heads"] = ch // 32
    if kind == "d":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
    out = fn(x, c, params, **kw)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("kind,n,img_w,ch", [
    ("c", 3136, 56, 96), ("d", 3136, 56, 96), ("d", 784, 28, 192),
    ("s", 196, 14, 384), ("s", 49, 7, 512), ("s", 192, 16, 192)])
def test_block_cpe_kernel_matches_plain_on_gpu(cuda, kind, n, img_w, ch,
                                               dtype, tol):
    """Each block kernel's cpe mode (pre-CPE x, the 3x3 CPE inside) against
    its plain version with cpe_plain; N = 192 is a 12 x 16 image."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, n, ch).astype(np.float32))
    c = torch.from_numpy(rng.randn(2, M, ch).astype(np.float32))
    params = [torch.from_numpy(a) for a in make_params(kind, rng, ch, 4 * ch)]
    cpe = [torch.from_numpy(a).to(cuda, dtype) for a in _cpe(rng, ch)]
    xd, cd = x.to(cuda, dtype), c.to(cuda, dtype)
    pd = [p.to(cuda, dtype) for p in params]
    name = {"c": "c_block", "d": "dca_block", "s": "s_block"}[kind]
    before = fb.LAUNCHES[name]
    got = _block_call(kind, getattr(fb, name), xd, cd, pd, n, ch, cpe=cpe,
                      img_w=img_w)
    torch.cuda.synchronize()
    assert fb.LAUNCHES[name] == before + 1
    want = _block_call(kind, PLAIN[name], xd.float(), cd.float(),
                       [p.float() for p in pd], n, ch,
                       cpe=[t.float() for t in cpe], img_w=img_w)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.float(), w_, rtol=tol, atol=tol)


def _stage_inputs(rng, nb, n, ch, use_cpe):
    """x, c, the blocks' parameter tuples (the proj and fc2 weights scaled
    by (2 nb)^-1/2) and CPEs (taps 0.1 N(0, 1)), so x keeps its scale over
    the stage."""
    x = rng.randn(2, n, ch).astype(np.float32)
    c = rng.randn(2, M, ch).astype(np.float32)
    params = []
    for _ in range(nb):
        p = make_params("s", rng, ch, 4 * ch)
        for i in (4, 10):
            p[i] = p[i] * (2 * nb) ** -0.5
        params.append(p)
    cpes = [_cpe(rng, ch, 0.1) for _ in range(nb)] if use_cpe else None
    return x, c, params, cpes


@pytest.mark.gpu
@pytest.mark.parametrize("use_cpe", [False, True], ids=["no_cpe", "cpe"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("nb,n,img_w,ch", [(3, 196, 14, 384),
                                           (2, 49, 7, 512),
                                           (2, 1024, 32, 192)])
def test_s_stage_matches_plain_and_chain_on_gpu(cuda, nb, n, img_w, ch,
                                                dtype, tol, use_cpe):
    """s_stage (one launch) against s_stage_plain in fp32 on the same
    inputs, and against the chain of s_block kernels in its own type."""
    x, c, params, cpes = _stage_inputs(np.random.RandomState(12), nb, n, ch,
                                       use_cpe)
    dev = lambda a: torch.from_numpy(a).to(cuda, dtype)  # noqa: E731
    xd, cd = dev(x), dev(c)
    pd = [[dev(a) for a in p] for p in params]
    cd_ = None if cpes is None else [[dev(a) for a in cp] for cp in cpes]
    kw = dict(num_heads=ch // 32, img_w=img_w)
    before = dict(fb.LAUNCHES)
    got = fb.s_stage(xd, cd, pd, cpes=cd_, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fb.LAUNCHES.items()
            if v != before[k]} == {"s_stage": 1}
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    want = fb.s_stage_plain(xd.float(), cd.float(), [f32(p) for p in pd],
                            cpes=None if cd_ is None else
                            [f32(cp) for cp in cd_], **kw)
    chain = (xd, cd)
    for j, p in enumerate(pd):
        chain = fb.s_block(*chain, p, cpe=None if cd_ is None else cd_[j],
                           **kw)
    for g_, w_, k_ in zip(got, want, chain):
        assert torch.isfinite(g_).all()
        scale = w_.abs().max().item() if dtype == torch.bfloat16 else 1.0
        torch.testing.assert_close(g_.float(), w_, rtol=tol,
                                   atol=tol * scale)
        torch.testing.assert_close(g_.float(), k_.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
def test_s_stage_rejects_what_it_does_not_take_on_gpu(cuda):
    rng = np.random.RandomState(13)
    x, c, params, _ = _stage_inputs(rng, 2, 64, 64, False)
    pd = [[torch.from_numpy(a).to(cuda) for a in p] for p in params]
    xd = torch.from_numpy(x).to(cuda)
    with pytest.raises(ValueError, match="stage_takes"):  # M % 8
        fb.s_stage(xd, torch.randn(2, 12, 64, device=cuda), pd, num_heads=2)
    with pytest.raises(ValueError, match="head_dim"):
        fb.s_stage(xd, torch.from_numpy(c).to(cuda), pd, num_heads=4)


@pytest.mark.gpu
def test_model_slice_path_matches_torch_path_on_gpu(cuda):
    """lemevit_tiny at 224^2, fp32, with s_stage and cpe_in_kernel: one
    s_stage launch per S stage, the C and D kernels with their CPE, no
    s_block; logits against the plain path."""
    m = lemevit_tpu_torch.create_model("lemevit_tiny", s_stage=True,
                                       cpe_in_kernel=True).eval()
    x = torch.randn(2, 224, 224, 3, device="cuda")
    before = dict(fb.LAUNCHES)
    with torch.no_grad():
        got = m(x)
        launched = {k: v - before[k] for k, v in fb.LAUNCHES.items()
                    if v != before[k]}
        m.set_attn_backend("torch")
        want = m(x)
    assert launched == {"c_block": 1, "dca_block": 4, "s_stage": 2}
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------ the probes


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ew.SHAPES)
@pytest.mark.parametrize("k", ["1", "jax"])
@pytest.mark.parametrize("op", list(ew.OPS))
def test_ew_probe_matches_plain_on_gpu(cuda, op, k, shape):
    """k_ew_probe<op, K> on each of vpu_probe's (R, C) tiles x 64 against
    ew_probe_plain on the card: within ew.max_ulps(K) bf16 steps (ATOL
    near zero), at K = 1 and at vpu_probe's K. At C = 384 and 784 a warp's
    lanes hold unequal counts of 16-byte vectors (48 and 98), so the
    masked loads, stores and row reductions run."""
    k = ew.jax_k(op) if k == "jax" else int(k)
    x = ew.probe_input(*shape, cuda)
    before = ew.LAUNCHES[f"ew_probe.{op}"]
    got = ew.ew_probe(x, op, k)
    torch.cuda.synchronize()
    assert ew.LAUNCHES[f"ew_probe.{op}"] == before + 1
    m = ew.mismatches(got, ew.ew_probe_plain(x, op, k), k)
    assert m["bad"] == 0, m


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(constructs.PROBES))
def test_construct_probe_on_gpu(cuda, name):
    """Each construct probe's kernel against its plain version on the card,
    with a keep / FLIP verdict."""
    row = constructs.PROBES[name](cuda)
    assert row["ok"], row
    assert row["route"] == "cuda"
    assert row["verdict"].startswith(("keep", "FLIP")), row["verdict"]


@pytest.mark.gpu
@pytest.mark.parametrize("csize", [1, 2, 4, 8])
def test_cluster_probe_matches_plain_on_gpu(cuda, csize):
    got = constructs.cluster_probe(csize, constructs.CLUSTERS, cuda)
    assert torch.equal(got.cpu(), constructs.cluster_probe_plain(
        csize, constructs.CLUSTERS))
    assert constructs.cluster_occupancy(csize, cuda) > 0


@pytest.mark.gpu
def test_probe_wrappers_reject_on_gpu(cuda):
    x = ew.probe_input(8, 128, cuda)
    with pytest.raises(TypeError):
        ew.ew_probe(x.float(), "exp", 1)
    with pytest.raises(ValueError, match="K in"):
        ew.ew_probe(x, "exp", 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        ew.ew_probe(torch.zeros(8, 2056, dtype=torch.bfloat16,
                                device=cuda), "exp", 1)
    with pytest.raises(ValueError, match="out of range"):
        constructs.scatter_add_probe(
            torch.ones(4, 8, device=cuda),
            torch.tensor([0, 1, 2, 9], dtype=torch.int32, device=cuda), 4)
    with pytest.raises(TypeError):
        constructs.fold_probe(torch.ones(2, 3, 8, device=cuda))


@pytest.mark.gpu
def test_kbench_clis_on_gpu(cuda):
    """cli.kbench and cli.train_kbench on the card at a small batch: kernel
    and plain rows, s_stage against the chain."""
    from lemevit_tpu_torch.cli import kbench, train_kbench
    rows = kbench.main(["--stages", "4", "--batch-size", "8", "--reps", "2"])
    assert [r["impl"] for r in rows] == ["kernel", "plain"]
    staged = kbench.main(["--stages", "4", "--batch-size", "8", "--reps",
                          "2", "--s-stage", "--impls", "kernel"])
    assert [(r["impl"], r["form"]) for r in staged] == [
        ("kernel", "s_stage"), ("kernel", "chain")]
    rows = train_kbench.main(["--stages", "1", "--batch-size", "4",
                              "--reps", "2", "--cpe"])
    assert [r["impl"] for r in rows] == ["kernel", "plain"]
    assert all(r["grad_ms"] > 0 for r in rows)


@pytest.mark.gpu
def test_train_path_step_device_ms_on_gpu(cuda):
    """The training paths' A/B measure: the kernels' device ms per bare
    lemevit_tiny step with the switch off and on, in one pair."""
    from lemevit_tpu_torch.cli import probes as probes_cli
    d = probes_cli.step_device_ms("lemevit_tiny", cuda, pairs=1, steps=1)
    assert d["default_ms"] > 0 and d["switch_ms"] > 0, d
    assert all(v > 0 for v in d["elapsed_ms"].values()), d
