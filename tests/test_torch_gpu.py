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
(probes/ew.py::max_ulps), also where its row layout (ew.layout) leaves
lanes empty, pads a last slot or fills 32 lanes, with the kernel's layout
equal to ew.layout at every C; the construct probes exact (erf within
1e-6), the scatter's sums within 1e-6 of each bin's sum of |x| of the
fp64 sum in both of its branches.
The attention-only kernels are also held in bf16 against their order of
work in PyTorch (*_tiles_plain) at 1e-2 and within 2 bf16 steps of each
output's largest element (so that dca_attn's c_out, of values ~0.01, is
held at its own scale), dca_attn with 32 to MAX_META meta tokens against
dca_plain, and dca_attn bit for bit between two runs. The C, S and D block
kernels are held in bf16 against their tile models (*_block_tiles_plain),
with their cpe mode and D2, within 2 bf16 steps of each output's largest
element, and bit for bit between two runs; so are the S block's attention
backward and the MLP backward (train_tc.cuh) against
mlp_bwd_tiles_plain / s_attn_bwd_tiles_plain, the S block's training
forward (lm_s_train_fwd) against s_train_fwd_tiles_plain, the D block's
training forward (lm_dca_train_fwd) against dca_train_fwd_tiles_plain and
its attention backward (lm_dca_attn_bwd) against dca_attn_bwd_tiles_plain,
and the C block's (lm_c_train_fwd, lm_c_attn_bwd, also with 320 meta
tokens) against c_train_fwd_tiles_plain / c_attn_bwd_tiles_plain, all
against their plain phases in fp32 at 1e-4 of each tensor's largest
element. LeMeViT's constructor defaults (head_dim 64) run under "auto" on
the card by composing, and match "torch"."""
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
@pytest.mark.parametrize("n,ch", [(16, 96), (196, 320), (1024, 192),
                                  (200, 192), (1, 96)])
def test_mhsa_matches_plain_on_gpu(cuda, n, ch, dtype, tol):
    """mhsa on column views of a qkv projection against mhsa_plain in fp32
    on the same inputs; N = 200 leaves a ragged last key and query tile,
    N = 1 and 16 take one warp per (image, head)."""
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


BF16_STEP = 2.0 ** -7  # bf16's spacing at 1


def _close_at_scale(got, want, tol, steps):
    """assert_close at rtol = atol = tol (unless tol is None), and the
    largest error within ``steps`` bf16 steps of the reference's largest
    element."""
    got, want = got.float(), want.float()
    if tol is not None:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err = (got - want).abs().max().item()
    assert err <= steps * BF16_STEP * want.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch", [(16, 96), (200, 192), (1024, 192)])
def test_mhsa_matches_tiles_model_on_gpu(cuda, n, ch):
    """bf16 mhsa against mhsa_tiles_plain, its order of work in PyTorch,
    on the same inputs (1e-2, and 2 bf16 steps of the largest output)."""
    from lemevit_tpu_torch.attn import mhsa
    g = torch.Generator().manual_seed(10)
    qkv = torch.randn(2, n, 3 * ch, generator=g).to(cuda, torch.bfloat16)
    args = qkv.split(ch, -1)
    kw = dict(scale=32 ** -0.5, num_heads=ch // 32)
    got = mhsa.mhsa_kernel(*args, **kw)
    want = mhsa.mhsa_tiles_plain(*args, **kw)
    _close_at_scale(got, want, 1e-2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,m", [(1000, 64, 16), (4096, 128, 16),
                                    (16384, 64, 16), (1000, 64, 32),
                                    (4096, 128, 128)])
def test_dca_attn_matches_tiles_model_on_gpu(cuda, n, ch, m):
    """bf16 dca_attn with m meta tokens against dca_tiles_plain, its order
    of work in PyTorch, on the same inputs (1e-2, and 2 bf16 steps of
    each output's largest element: c_out's values are ~0.01 at N =
    16384)."""
    from lemevit_tpu_torch.attn import dca
    g = torch.Generator().manual_seed(11)
    lin1 = torch.randn(2, n, 3 * ch, generator=g).to(cuda, torch.bfloat16)
    lin2 = torch.randn(2, m, 3 * ch, generator=g).to(cuda, torch.bfloat16)
    args = (*lin1.split(ch, -1), *lin2.split(ch, -1))
    sx, sc = dca_scales(n, m, ch)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=ch // 32)
    got = dca.dca_kernel(*args, **kw)
    want = dca.dca_tiles_plain(*args, **kw)
    for g_, w_ in zip(got, want):
        _close_at_scale(g_, w_, 1e-2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,m", [(1000, 32), (4096, 128), (1000, "max")])
def test_dca_attn_more_meta_tokens_on_gpu(cuda, n, m, dtype, tol):
    """dca_attn with more than one tile of 16 meta tokens (128 is
    LeMeViT's default queries_len; "max" is MAX_META[dtype], the most
    whose rows fit in shared memory) against dca_plain in fp32 on the same
    inputs, D2's aliased form too; bf16 also within 4 bf16 steps of each
    output's largest element. One tile more raises."""
    from lemevit_tpu_torch.attn import dca
    m = dca.MAX_META[dtype] if m == "max" else m
    ch = 64
    g = torch.Generator().manual_seed(13)
    lin1 = torch.randn(2, n, 3 * ch, generator=g).to(cuda, dtype)
    lin2 = torch.randn(2, m, 3 * ch, generator=g).to(cuda, dtype)
    q1, k1, v1 = lin1.split(ch, -1)
    q2, k2, v2 = lin2.split(ch, -1)
    sx, sc = dca_scales(n, m, ch)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=ch // 32)
    for args in ((q1, k1, v1, q2, k2, v2), (q1, q1, v1, k2, k2, v2)):
        got = dca.dca_kernel(*args, **kw)
        want = dca.dca_plain(*[t.float() for t in args], **kw)
        for g_, w_ in zip(got, want):
            if dtype == torch.bfloat16:
                _close_at_scale(g_, w_, tol, 4)
            else:
                torch.testing.assert_close(g_, w_, rtol=tol, atol=tol)
    more = torch.randn(2, dca.MAX_META[dtype] + 16, ch,
                       generator=g).to(cuda, dtype)
    with pytest.raises(ValueError, match="meta tokens"):
        dca.dca_kernel(q1, k1, v1, more, more, more, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dca_attn_is_deterministic_on_gpu(cuda, dtype):
    """Two runs of dca_attn on the same inputs give the same bits (the c
    direction's partials merge in a fixed order, no atomics), D2's
    aliased form too."""
    from lemevit_tpu_torch.attn import dca
    g = torch.Generator().manual_seed(12)
    n, ch = 4096, 128
    lin1 = torch.randn(2, n, 3 * ch, generator=g).to(cuda, dtype)
    lin2 = torch.randn(2, M, 3 * ch, generator=g).to(cuda, dtype)
    q1, k1, v1 = lin1.split(ch, -1)
    q2, k2, v2 = lin2.split(ch, -1)
    sx, sc = dca_scales(n, M, ch)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=ch // 32)
    for args in ((q1, k1, v1, q2, k2, v2), (q1, q1, v1, k2, k2, v2)):
        first = dca.dca_kernel(*args, **kw)
        second = dca.dca_kernel(*args, **kw)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


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


# S and D kernels (block_tc.cuh): (kind, N, C, M). Base's and
# lemevit_tiny's shapes, a ragged N, 32 and 128 meta tokens, and widths
# that the tail's accumulator rounds up to a tier (32, 160, 448) or that
# reach MAX_DIM (640). fp32 runs the same kernels as bf16 (FMA products),
# block_common.cuh's tail past C = 512.
TILE_CASES = [("s", 196, 384, 16), ("s", 49, 512, 16), ("s", 200, 192, 16),
              ("s", 196, 384, 32), ("s", 49, 512, 128), ("s", 64, 640, 16),
              ("s", 49, 448, 16), ("s", 16, 32, 16), ("d", 784, 192, 16),
              ("d", 3136, 96, 16), ("d", 1000, 96, 16), ("d", 784, 192, 32),
              ("d", 784, 192, 128), ("d", 256, 160, 16), ("d", 64, 640, 16),
              # the C block: base's and lemevit_tiny's stage 0, a ragged N,
              # and 300 meta tokens (two chunks of the attention's CTAs)
              ("c", 3136, 96, 16), ("c", 3136, 64, 16), ("c", 1000, 96, 16),
              ("c", 200, 64, 300)]
TILES = {"c": fb.c_block_tiles_plain, "s": fb.s_block_tiles_plain,
         "d": fb.dca_block_tiles_plain}
BLOCKS = {"c": "c_block", "s": "s_block", "d": "dca_block"}
# bf16 against the tile models: within TILES_STEPS bf16 steps of each
# output's largest element, as chip_smoke.py holds them (a fp32 sum taken
# in another order can flip one of the model's roundings, and an output
# that cancels terms of the size of the largest then differs by a step of
# those terms)
TILES_STEPS = 2


def _tile_call(kind, fn, x, c, params, **kw):
    """fn's outputs as a tuple (the C block returns c_out alone)."""
    n, m, ch = x.shape[1], c.shape[1], x.shape[2]
    kw["num_heads"] = ch // 32
    if kind == "d":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, m, ch)
    out = fn(x, c, params, **kw)
    return out if isinstance(out, tuple) else (out,)


def _tile_inputs(kind, n, ch, m, seed, cpe_w=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, n, ch).astype(np.float32))
    c = torch.from_numpy(rng.randn(2, m, ch).astype(np.float32))
    params = [torch.from_numpy(a) for a in make_params(kind, rng, ch, 4 * ch)]
    cpe = [torch.from_numpy(a) for a in _cpe(rng, ch)] if cpe_w else None
    return x, c, params, cpe


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,ch,m", TILE_CASES)
def test_block_tc_kernel_matches_plain_and_tiles_model_on_gpu(cuda, kind, n,
                                                              ch, m):
    """The C / S / D kernel in fp32 against its plain version (1e-4); in
    bf16 against its order of work in PyTorch (*_block_tiles_plain) on the
    same inputs (TILES_STEPS), and bit for bit between two runs; one launch
    a call."""
    x, c, params, _ = _tile_inputs(kind, n, ch, m, 21)
    name = BLOCKS[kind]
    xd, cd, pd = x.to(cuda), c.to(cuda), [p.to(cuda) for p in params]
    before = fb.LAUNCHES[name]
    got = _tile_call(kind, getattr(fb, name), xd, cd, pd)
    torch.cuda.synchronize()
    assert fb.LAUNCHES[name] == before + 1
    want = _tile_call(kind, PLAIN[name], xd, cd, pd)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)
    bf = torch.bfloat16
    xb, cb, pb = xd.to(bf), cd.to(bf), [p.to(bf) for p in pd]
    got = _tile_call(kind, getattr(fb, name), xb, cb, pb)
    again = _tile_call(kind, getattr(fb, name), xb, cb, pb)
    want = _tile_call(kind, TILES[kind], xb, cb, pb)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,img_w,ch", [("s", 196, 14, 384),
                                             ("d", 784, 28, 192),
                                             ("d", 3136, 56, 96),
                                             ("c", 3136, 56, 96)])
def test_block_tc_cpe_matches_tiles_model_on_gpu(cuda, kind, n, img_w, ch):
    """The cpe mode in bf16 against the tile model with the same CPE."""
    x, c, params, cpe = _tile_inputs(kind, n, ch, M, 22, img_w)
    bf = torch.bfloat16
    xb, cb = x.to(cuda, bf), c.to(cuda, bf)
    pb, cpb = [p.to(cuda, bf) for p in params], [t.to(cuda, bf) for t in cpe]
    name = BLOCKS[kind]
    got = _tile_call(kind, getattr(fb, name), xb, cb, pb, cpe=cpb,
                     img_w=img_w)
    want = _tile_call(kind, TILES[kind], xb, cb, pb, cpe=cpb, img_w=img_w)
    for g_, w_ in zip(got, want):
        _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
def test_dca_block_d2_matches_tiles_model_on_gpu(cuda):
    """D2 through LeMeBlock's weight permutation: the kernel in bf16
    against the tile model on the permuted weights."""
    from lemevit_tpu_torch.models.lemevit import LeMeBlock
    torch.manual_seed(23)
    blk = LeMeBlock(192, 6, "D2").to(cuda).eval()
    params = [t.detach().to(torch.bfloat16) for t in blk.fused_params()]
    g = torch.Generator().manual_seed(24)
    x = torch.randn(2, 784, 192, generator=g).to(cuda, torch.bfloat16)
    c = torch.randn(2, M, 192, generator=g).to(cuda, torch.bfloat16)
    got = _tile_call("d", fb.dca_block, x, c, params)
    want = _tile_call("d", fb.dca_block_tiles_plain, x, c, params)
    for g_, w_ in zip(got, want):
        _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
def test_dca_block_rejects_more_meta_tokens_than_it_takes_on_gpu(cuda):
    from lemevit_tpu_torch.attn import dca
    for dtype in (torch.float32, torch.bfloat16):
        m = dca.MAX_META[dtype] + 16
        x, c, params, _ = _tile_inputs("d", 64, 64, m, 25)
        with pytest.raises(ValueError, match="MAX_META"):
            _tile_call("d", fb.dca_block, x.to(cuda, dtype),
                       c.to(cuda, dtype), [p.to(cuda, dtype) for p in params])


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
                                           (2, 1024, 32, 192),
                                           (2, 49, 7, 640),
                                           (2, 20, 5, 64)])
def test_s_stage_matches_plain_and_chain_on_gpu(cuda, nb, n, img_w, ch,
                                                dtype, tol, use_cpe):
    """s_stage (one persistent launch of the S block's tiles) against
    s_stage_plain in fp32 on the same inputs, and bit for bit against the
    chain of s_block kernels in its own type and a second call (C = 640:
    block_common.cuh's 32-row tails; N = 20: 64-row blocks over four
    images)."""
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
    again = fb.s_stage(xd, cd, pd, cpes=cd_, **kw)
    for g_, w_, k_, a_ in zip(got, want, chain, again):
        assert torch.isfinite(g_).all()
        scale = w_.abs().max().item() if dtype == torch.bfloat16 else 1.0
        torch.testing.assert_close(g_.float(), w_, rtol=tol,
                                   atol=tol * scale)
        assert torch.equal(g_, k_) and torch.equal(g_, a_)


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
@pytest.mark.parametrize("shape", [(300, 8), (300, 392), (300, 2048)])
@pytest.mark.parametrize("k", ["0", "1", "jax"])
@pytest.mark.parametrize("op", list(ew.OPS))
def test_ew_probe_layouts_on_gpu(cuda, op, k, shape):
    """k_ew_probe at a few hundred rows where ew.layout puts one vector in
    a group of 8 lanes (C = 8), 8 lanes of 7 slots with the last in one
    lane (392) and 32 lanes of 8 full slots (2048): K = 0 exact, K = 1 and
    vpu_probe's K within ew.max_ulps."""
    k = ew.jax_k(op) if k == "jax" else int(k)
    x = ew.probe_input(*shape, cuda)[:shape[0]]
    got = ew.ew_probe(x, op, k)
    if k == 0:
        assert torch.equal(got, x)
    m = ew.mismatches(got, ew.ew_probe_plain(x, op, k), k)
    assert m["bad"] == 0, m


@pytest.mark.gpu
def test_ew_kernel_layout_on_gpu(cuda):
    assert all(ew.kernel_layout(c) == ew.layout(c)
               for c in range(8, ew.MAX_COLS + 1, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,bins,sort", [
    (200704, 64, 1, False), (200704, 64, 4096, False), (5000, 320, 16, True),
    (777, 12, 3, False), (128, 128, 128, False)])
def test_scatter_add_probe_on_gpu(cuda, rows, cols, bins, sort):
    """k_scatter_add_probe in its shared-partial and global branches
    (scatter_plan) against the fp64 sum and its tile model."""
    g = torch.Generator().manual_seed(rows + bins)
    x = torch.randn(rows, cols, generator=g)
    idx = torch.randint(0, bins, (rows,), generator=g, dtype=torch.int32)
    if sort:
        idx = idx.sort().values
    x, idx = x.to(cuda), idx.to(cuda)
    got = constructs.scatter_add_probe(x, idx, bins)
    assert constructs.sum_err(got, x, idx, bins) <= 1.0
    tiles = constructs.scatter_add_probe_tiles_plain(x, idx, bins).to(cuda)
    assert constructs.sum_err(tiles, x, idx, bins) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 1025, 4097, 65538])
@pytest.mark.parametrize("poly", [False, True])
def test_erf_probe_ragged_on_gpu(cuda, n, poly):
    """k_erf_probe where n % 4 leaves a partial last vector and where the
    last tile is partial (erf_plan), against its plain version."""
    x = torch.linspace(-4, 4, n, dtype=torch.float32)
    for k in (1, 3):
        got = constructs.erf_probe(x.to(cuda), poly, k).cpu()
        want = constructs.erf_probe_plain(x, poly, k)
        assert (got - want).abs().max().item() <= k * constructs.ERF_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 8), (3, 5, 16), (2, 1023, 8),
                                   (1, 1024, 32), (4, 784, 320)])
def test_fold_probe_ragged_on_gpu(cuda, shape):
    """k_fold_probe on full and partial tiles (fold_plan): exact."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to(torch.bfloat16).to(cuda)
    assert torch.equal(constructs.fold_probe(x),
                       constructs.fold_probe_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("shift", ["0", "1", "rows-1", "rows", -57,
                                   2 ** 32 + 57, -2 ** 31])
@pytest.mark.parametrize("shape", [(1, 4), (5, 12), (127, 16), (128, 16),
                                   (129, 16), (3136, 64), (200704, 64)])
def test_roll_rows_probe_shifts_on_gpu(cuda, shape, shift):
    """k_roll_rows_probe on full and partial tiles (roll_plan), bit for bit
    torch.roll, at shifts past the rows, negative and past int32 (2**32 +
    57 rolled by 57 rows while the shift went to the kernel unnormalised)."""
    rows = shape[0]
    shift = {"0": 0, "1": 1, "rows-1": rows - 1, "rows": rows}.get(shift,
                                                                  shift)
    x = torch.arange(rows * shape[1], dtype=torch.float32,
                     device=cuda).reshape(shape)
    before = constructs.LAUNCHES["roll_rows_probe"]
    got = constructs.roll_rows_probe(x, shift)
    assert constructs.LAUNCHES["roll_rows_probe"] == before + 1
    want = torch.roll(x, shift, 0)
    assert torch.equal(got, want), (got[0, 0].item(), want[0, 0].item())


@pytest.mark.gpu
def test_roll_rows_probe_launcher_refuses_on_gpu(cuda):
    """lm_roll_rows_probe refuses a grid or an s that is not roll_plan's,
    and the wrapper a shape the kernel does not take."""
    from lemevit_tpu_torch import probes
    x = constructs.roll_input(cuda)
    out = torch.empty_like(x)
    p = constructs.roll_plan(*x.shape, constructs.ROLL_SHIFT)
    n, s, grid = p["n"], p["s"], p["grid"]
    for args in ((n, s, grid + 1), (n, s, grid - 1), (n, s, 0), (n, n, grid),
                 (n, -1, grid), (0, 0, 1)):
        before = constructs.LAUNCHES["roll_rows_probe"]
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            probes.launch("roll_rows_probe", x, x, out, *args,
                          counts=constructs.LAUNCHES)
        assert constructs.LAUNCHES["roll_rows_probe"] == before
    with pytest.raises(ValueError, match="multiple of 4"):
        constructs.roll_rows_probe(torch.ones(8, 6, device=cuda), 1)
    with pytest.raises(TypeError):
        constructs.roll_rows_probe(x.double(), 1)


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


# Rows 10-11 (train_tc.cuh): (N, C, batch) at lemevit_tiny's, vit_tiny's and
# the seg path's S shapes, and a ragged N past a 64-row tile
BWD_TC_SHAPES = [(196, 192, 4), (49, 320, 4), (784, 192, 2), (196, 320, 2),
                 (49, 384, 4), (1024, 192, 2), (256, 320, 2), (200, 192, 2)]


def _bwd_inputs(cuda, n, ch, b, dtype, seed, cpe_w=0):
    """x, c, the S block's folded params, DropPath scales, the upstream
    gradients and, with cpe_w, a CPE pair, then the plain forward's t1, o
    and lse in dtype (inputs rounded to dtype first)."""
    rng = np.random.RandomState(seed)
    hid = 4 * ch
    arrays = ([rng.randn(b, n, ch), rng.randn(b, M, ch)]
              + _lin(rng, 3 * ch, ch) + _lin(rng, ch, ch)
              + _lin(rng, hid, ch) + _lin(rng, ch, hid)
              + [rng.randn(b, n, ch), rng.randn(b, M, ch)])
    ts = [torch.tensor(a.astype(np.float32), device=cuda).to(dtype)
          for a in arrays]
    x, c, params, gx, gc = ts[0], ts[1], ts[2:10], ts[10], ts[11]
    dp = torch.from_numpy(((rng.rand(4, b) < 0.7) / 0.7).astype(
        np.float32)).to(cuda)
    cpe = ([torch.tensor(a, device=cuda).to(dtype) for a in _cpe(rng, ch)]
           if cpe_w else None)
    kw = {"num_heads": ch // 32}
    if cpe_w:
        kw.update(cpe=cpe, img_w=cpe_w)
    fwd = ft.s_train_fwd_plain(x, c, params, dp, **kw)
    return x, c, params, dp, gx, gc, fwd, kw


def _bwd_calls(x, c, params, dp, gx, gc, fwd, kw, mlp, attn):
    """(mlp_bwd outputs, s_attn_bwd outputs) of the given phase functions,
    the attention backward on the MLP backward's dt1."""
    wqkv, bqkv, wp, _, w1, b1, w2, _ = params
    _, _, t1x, t1c, ox, oc, lx, lc = fwd
    m_out = mlp(t1x, t1c, gx, gc, dp, w1, b1, w2)
    a_out = attn(x, c, m_out[0], m_out[1], dp, wqkv, bqkv, wp, ox, oc, lx,
                 lc, **kw)
    return list(m_out), [t for t in a_out if t is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,b", BWD_TC_SHAPES)
def test_bwd_tc_kernels_match_plain_and_tiles_models_on_gpu(cuda, n, ch, b):
    """lm_mlp_bwd and lm_s_attn_bwd: fp32 against mlp_bwd_plain /
    s_attn_bwd_plain at 1e-4 of each tensor's largest element; bf16 against
    their tile models (mlp_bwd_tiles_plain, s_attn_bwd_tiles_plain) on the
    same inputs within TILES_STEPS bf16 steps of each tensor's largest
    element; each launched once (3 and 8 kernels on the card)."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _bwd_inputs(cuda, n, ch, b, dtype, 7)
        before = dict(ft.LAUNCHES)
        got_m, got_a = _bwd_calls(*args, ft.mlp_bwd, ft.s_attn_bwd)
        torch.cuda.synchronize()
        assert _launched(before) == {"mlp_bwd": 1, "s_attn_bwd": 1}
        if dtype == torch.float32:
            want_m, want_a = _bwd_calls(*args, ft.mlp_bwd_plain,
                                        ft.s_attn_bwd_plain)
        else:
            want_m, want_a = _bwd_calls(*args, ft.mlp_bwd_tiles_plain,
                                        ft.s_attn_bwd_tiles_plain)
        for i, (g_, w_) in enumerate(zip(got_m + got_a, want_m + want_a)):
            g_, w_ = g_.float(), w_.float()
            assert torch.isfinite(g_).all(), i
            if dtype == torch.float32:
                torch.testing.assert_close(
                    g_, w_, rtol=1e-4, atol=1e-4 * w_.abs().max().item(),
                    msg=f"tensor {i}")
            else:
                _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_tc_cpe_matches_plain_and_tiles_model_on_gpu(cuda, dtype):
    """lm_s_attn_bwd in its cpe mode (lemevit_tiny's stage 3, 14 x 14): fp32
    against s_attn_bwd_plain, bf16 against s_attn_bwd_tiles_plain, the tap
    and bias gradients included."""
    args = _bwd_inputs(cuda, 196, 192, 4, dtype, 8, cpe_w=14)
    got_m, got_a = _bwd_calls(*args, ft.mlp_bwd, ft.s_attn_bwd)
    plain = ((ft.mlp_bwd_plain, ft.s_attn_bwd_plain)
             if dtype == torch.float32 else
             (ft.mlp_bwd_tiles_plain, ft.s_attn_bwd_tiles_plain))
    want_m, want_a = _bwd_calls(*args, *plain)
    assert len(got_a) == len(want_a) == 8
    for i, (g_, w_) in enumerate(zip(got_a, want_a)):
        g_, w_ = g_.float(), w_.float()
        if dtype == torch.float32:
            torch.testing.assert_close(
                g_, w_, rtol=1e-4, atol=1e-4 * w_.abs().max().item(),
                msg=f"tensor {i}")
        else:
            _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,b", [(784, 192, 2), (200, 192, 2),
                                    (49, 384, 4)])
def test_bwd_tc_weight_grads_are_deterministic_on_gpu(cuda, n, ch, b):
    """Two calls of lm_mlp_bwd and lm_s_attn_bwd give the same bits (bf16):
    the weight gradients sum their row ranges in a fixed order."""
    args = _bwd_inputs(cuda, n, ch, b, torch.bfloat16, 9)
    runs = [_bwd_calls(*args, ft.mlp_bwd, ft.s_attn_bwd) for _ in range(2)]
    for g_, w_ in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(g_, w_)


@pytest.mark.gpu
def test_bwd_tc_mlp_empty_image_stream_on_gpu(cuda):
    """The C block's MLP backward: lm_mlp_bwd with no image tokens against
    its plain phase (fp32) and tile model (bf16)."""
    for dtype in (torch.float32, torch.bfloat16):
        x, c, params, dp, gx, gc, fwd, kw = _bwd_inputs(cuda, 16, 64, 8,
                                                        dtype, 10)
        none = x[:, :0]
        w1, b1, w2 = params[4], params[5], params[6]
        got = ft.mlp_bwd(none, fwd[3], none, gc, dp, w1, b1, w2)
        ref = (ft.mlp_bwd_plain if dtype == torch.float32
               else ft.mlp_bwd_tiles_plain)
        want = ref(none, fwd[3], none, gc, dp, w1, b1, w2)
        for g_, w_ in list(zip(got, want))[1:]:
            g_, w_ = g_.float(), w_.float()
            if dtype == torch.float32:
                torch.testing.assert_close(
                    g_, w_, rtol=1e-4, atol=1e-4 * w_.abs().max().item())
            else:
                _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
def test_bwd_tc_refuses_past_max_train_dim_on_gpu(cuda):
    """At C = 544 (under fused_block.MAX_DIM, over MAX_TRAIN_DIM) the S
    forward phase, lm_mlp_bwd and lm_s_attn_bwd raise a ValueError naming
    the limit and launch nothing."""
    ch = ft.MAX_TRAIN_DIM + 32
    x, c, params, dp, gx, gc, fwd, kw = _bwd_inputs(cuda, 16, ch, 1,
                                                    torch.float32, 11)
    before = dict(ft.LAUNCHES)
    with pytest.raises(ValueError, match="MAX_TRAIN_DIM"):
        ft.s_train_fwd(x, c, params, dp, **kw)
    with pytest.raises(ValueError, match="MAX_TRAIN_DIM"):
        _bwd_calls(x, c, params, dp, gx, gc, fwd, kw, ft.mlp_bwd,
                   ft.s_attn_bwd)
    wqkv, bqkv, wp = params[:3]
    with pytest.raises(ValueError, match="MAX_TRAIN_DIM"):
        ft.s_attn_bwd(x, c, gx, gc, dp, wqkv, bqkv, wp, *fwd[4:], **kw)
    assert _launched(before) == {}


# Row 9 (s_train.cu's lm_s_train_fwd on k_qkv_wg, k_mhsa_tc and k_tail_wg's
# training instance): (N, C, batch, image width for the cpe mode or 0)
FWD_TC_SHAPES = [(196, 192, 4, 0), (49, 320, 4, 0), (784, 192, 2, 0),
                 (1024, 192, 2, 0), (200, 192, 2, 0), (16, 64, 4, 0),
                 (196, 192, 4, 14)]


def _fwd_inputs(cuda, n, ch, b, dtype, seed, cpe_w=0):
    """x, c, the S block's folded params, DropPath scales (some 0) and the
    phase's keywords (with cpe_w, a CPE pair on images cpe_w wide), in
    dtype."""
    rng = np.random.RandomState(seed)
    hid = 4 * ch
    arrays = ([rng.randn(b, n, ch), rng.randn(b, M, ch)]
              + _lin(rng, 3 * ch, ch) + _lin(rng, ch, ch)
              + _lin(rng, hid, ch) + _lin(rng, ch, hid))
    ts = [torch.tensor(a.astype(np.float32), device=cuda).to(dtype)
          for a in arrays]
    dp = torch.from_numpy(((rng.rand(4, b) < 0.7) / 0.7).astype(
        np.float32)).to(cuda)
    kw = {"num_heads": ch // 32}
    if cpe_w:
        kw.update(cpe=[torch.tensor(a, device=cuda).to(dtype)
                       for a in _cpe(rng, ch)], img_w=cpe_w)
    return ts[0], ts[1], ts[2:], dp, kw


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,b,cpe_w", FWD_TC_SHAPES)
def test_s_train_fwd_tc_matches_plain_and_tiles_model_on_gpu(cuda, n, ch, b,
                                                            cpe_w):
    """lm_s_train_fwd: fp32 against s_train_fwd_plain at 1e-4 of each
    output's largest element (x_out, c_out, t1, o and the log-sum-exp of
    both streams); bf16 against s_train_fwd_tiles_plain within TILES_STEPS
    bf16 steps of each output's largest element, the log-sum-exp at 1e-3;
    one launch a call; two calls give the same bits."""
    for dtype in (torch.float32, torch.bfloat16):
        x, c, params, dp, kw = _fwd_inputs(cuda, n, ch, b, dtype, 12, cpe_w)
        before = dict(ft.LAUNCHES)
        got = ft.s_train_fwd(x, c, params, dp, **kw)
        torch.cuda.synchronize()
        assert _launched(before) == {"s_train_fwd": 1}
        again = ft.s_train_fwd(x, c, params, dp, **kw)
        for g_, a_ in zip(got, again):
            assert torch.equal(g_, a_)
        ref = (ft.s_train_fwd_plain if dtype == torch.float32
               else ft.s_train_fwd_tiles_plain)
        want = ref(x, c, params, dp, **kw)
        for i, (g_, w_) in enumerate(zip(got, want)):
            g_, w_ = g_.float(), w_.float()
            assert g_.shape == w_.shape and torch.isfinite(g_).all(), i
            if dtype == torch.float32:
                torch.testing.assert_close(
                    g_, w_, rtol=1e-4, atol=1e-4 * w_.abs().max().item(),
                    msg=f"output {i}")
            elif i >= 6:  # the log-sum-exp, fp32 from rounded q and k
                torch.testing.assert_close(g_, w_, rtol=1e-3, atol=1e-3)
            else:
                _close_at_scale(g_, w_, None, TILES_STEPS)


# Row 13 (dca_train.cu's lm_dca_attn_bwd on k_qkv_wg, k_rowmm_wg,
# k_dca_bwd_tc and k_wgrad_tc): (N, C, batch, M, D2, image width for the
# cpe mode or 0)
DCA_BWD_SHAPES = [(3136, 64, 2, 16, False, 0), (784, 128, 2, 16, False, 0),
                  (1000, 64, 2, 16, False, 0), (784, 128, 2, 48, False, 0),
                  (784, 128, 2, 16, True, 0), (3136, 64, 2, 16, False, 56)]


def _dca_inputs(cuda, n, ch, b, m, d2, dtype, seed, cpe_w=0):
    """x, c, the D block's folded params (D2: the permuted [Wq|Wq|Wv1] /
    [Wk|Wk|Wv2] weights), DropPath scales (some 0), upstream gradients
    dt1x, dt1c and the phases' keywords (with cpe_w, a CPE pair on images
    cpe_w wide), in dtype."""
    rng = np.random.RandomState(seed)
    hid = 4 * ch
    if d2:
        wq, wv1, wk, wv2 = (_lin(rng, ch, ch) for _ in range(4))
        attn = [np.concatenate([wq[0], wq[0], wv1[0]]),
                np.concatenate([wq[1], wq[1], wv1[1]]),
                np.concatenate([wk[0], wk[0], wv2[0]]),
                np.concatenate([wk[1], wk[1], wv2[1]])]
    else:
        attn = _lin(rng, 3 * ch, ch) + _lin(rng, 3 * ch, ch)
    arrays = ([rng.randn(b, n, ch), rng.randn(b, m, ch)] + attn
              + _lin(rng, ch, ch) + _lin(rng, ch, ch)
              + _lin(rng, hid, ch) + _lin(rng, ch, hid)
              + [rng.randn(b, n, ch), rng.randn(b, m, ch)])
    ts = [torch.tensor(a.astype(np.float32), device=cuda).to(dtype)
          for a in arrays]
    x, c, params, dt1x, dt1c = ts[0], ts[1], ts[2:14], ts[14], ts[15]
    dp = torch.from_numpy(((rng.rand(4, b) < 0.7) / 0.7).astype(
        np.float32)).to(cuda)
    kw = {"num_heads": ch // 32}
    kw["scale_x"], kw["scale_c"] = dca_scales(n, m, ch)
    if cpe_w:
        kw.update(cpe=[torch.tensor(a, device=cuda).to(dtype)
                       for a in _cpe(rng, ch)], img_w=cpe_w)
    return x, c, params, dp, dt1x, dt1c, kw


def _dca_bwd_args(x, c, params, dp, dt1x, dt1c, fwd):
    """The D attention backward's arguments on a forward's o and lse."""
    wqkv1, bqkv1, wqkv2, bqkv2, wpx, _, wpc = params[:7]
    return (x, c, dt1x, dt1c, dp, wqkv1, bqkv1, wqkv2, bqkv2, wpx, wpc,
            *fwd[4:])


def _dca_bwd_inputs(cuda, n, ch, b, m, d2, dtype, seed, cpe_w=0):
    """The D attention backward's arguments in dtype, its keywords, o and
    lse from the plain forward in dtype."""
    x, c, params, dp, dt1x, dt1c, kw = _dca_inputs(cuda, n, ch, b, m, d2,
                                                   dtype, seed, cpe_w)
    fwd = ft.dca_train_fwd_plain(x, c, params, dp, **kw)
    return _dca_bwd_args(x, c, params, dp, dt1x, dt1c, fwd), kw


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,b,m,d2,cpe_w", DCA_BWD_SHAPES)
def test_dca_attn_bwd_tc_matches_plain_and_tiles_model_on_gpu(
        cuda, n, ch, b, m, d2, cpe_w):
    """lm_dca_attn_bwd: fp32 against dca_attn_bwd_plain at 1e-4 of each
    tensor's largest element (dx, dc, every weight and bias gradient, with
    the CPE the taps' and bias's too); bf16 against
    dca_attn_bwd_tiles_plain within TILES_STEPS bf16 steps of each tensor's
    largest element; one launch a call; two calls give the same bits."""
    for dtype in (torch.float32, torch.bfloat16):
        args, kw = _dca_bwd_inputs(cuda, n, ch, b, m, d2, dtype, 13, cpe_w)
        before = dict(ft.LAUNCHES)
        got = [t for t in ft.dca_attn_bwd(*args, **kw) if t is not None]
        torch.cuda.synchronize()
        assert _launched(before) == {"dca_attn_bwd": 1}
        again = [t for t in ft.dca_attn_bwd(*args, **kw) if t is not None]
        for g_, a_ in zip(got, again):
            assert torch.equal(g_, a_)
        ref = (ft.dca_attn_bwd_plain if dtype == torch.float32
               else ft.dca_attn_bwd_tiles_plain)
        want = [t for t in ref(*args, **kw) if t is not None]
        assert len(got) == len(want) == (12 if cpe_w else 10)
        for i, (g_, w_) in enumerate(zip(got, want)):
            g_, w_ = g_.float(), w_.float()
            assert g_.shape == w_.shape and torch.isfinite(g_).all(), i
            if dtype == torch.float32:
                torch.testing.assert_close(
                    g_, w_, rtol=1e-4, atol=1e-4 * w_.abs().max().item(),
                    msg=f"tensor {i}")
            else:
                _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,b,m,d2,cpe_w", DCA_BWD_SHAPES)
def test_dca_train_fwd_tc_matches_plain_and_tiles_model_on_gpu(
        cuda, n, ch, b, m, d2, cpe_w):
    """Row 12, lm_dca_train_fwd (k_qkv_wg, k_dca_tc + k_dca_merge with the
    log-sum-exps, k_tail_wg's training instance): fp32 against
    dca_train_fwd_plain at 1e-4 of each output's largest element (x_out,
    c_out, t1x, t1c, o and the log-sum-exp of both directions); bf16
    against dca_train_fwd_tiles_plain within TILES_STEPS bf16 steps of
    each output's largest element, the log-sum-exps at 1e-3; one launch a
    call; two calls give the same bits; in fp32 row 13 on this forward's o
    and log-sum-exp matches it on the plain forward's at 1e-4."""
    for dtype in (torch.float32, torch.bfloat16):
        x, c, params, dp, dt1x, dt1c, kw = _dca_inputs(cuda, n, ch, b, m, d2,
                                                       dtype, 15, cpe_w)
        before = dict(ft.LAUNCHES)
        got = ft.dca_train_fwd(x, c, params, dp, **kw)
        torch.cuda.synchronize()
        assert _launched(before) == {"dca_train_fwd": 1}
        again = ft.dca_train_fwd(x, c, params, dp, **kw)
        for g_, a_ in zip(got, again):
            assert torch.equal(g_, a_)
        ref = (ft.dca_train_fwd_plain if dtype == torch.float32
               else ft.dca_train_fwd_tiles_plain)
        want = ref(x, c, params, dp, **kw)
        for i, (g_, w_) in enumerate(zip(got, want)):
            g_, w_ = g_.float(), w_.float()
            assert g_.shape == w_.shape and torch.isfinite(g_).all(), i
            if dtype == torch.float32:
                torch.testing.assert_close(
                    g_, w_, rtol=1e-4, atol=1e-4 * w_.abs().max().item(),
                    msg=f"output {i}")
            elif i >= 6:  # the log-sum-exps, fp32 from rounded q and k
                torch.testing.assert_close(g_, w_, rtol=1e-3, atol=1e-3)
            else:
                _close_at_scale(g_, w_, None, TILES_STEPS)
        if dtype == torch.float32:
            on_kernel = ft.dca_attn_bwd(
                *_dca_bwd_args(x, c, params, dp, dt1x, dt1c, got), **kw)
            on_plain = ft.dca_attn_bwd(
                *_dca_bwd_args(x, c, params, dp, dt1x, dt1c, want), **kw)
            for g_, w_ in zip(on_kernel, on_plain):
                if w_ is not None:
                    torch.testing.assert_close(
                        g_, w_, rtol=1e-4,
                        atol=1e-4 * w_.abs().max().item())


@pytest.mark.gpu
def test_dca_train_refuses_more_meta_tokens_than_it_takes_on_gpu(cuda):
    """Past MAX_META the D training phases raise a ValueError naming the
    limit and launch nothing."""
    from lemevit_tpu_torch.attn import dca
    m = dca.MAX_META[torch.float32] + 8
    args, kw = _dca_bwd_inputs(cuda, 64, 64, 1, m, False, torch.float32, 14)
    before = dict(ft.LAUNCHES)
    with pytest.raises(ValueError, match="MAX_META"):
        ft.dca_attn_bwd(*args, **kw)
    assert _launched(before) == {}


@pytest.mark.gpu
def test_constructor_defaults_compose_on_gpu(cuda):
    """LeMeViT() with its own defaults (head_dim 64, 128 meta tokens) at
    64^2 under "auto" on the card: the blocks decline by shape and compose,
    so a forward and a training step run, launch no block kernel, and match
    attn_backend="torch" (fp32; logits and every gradient at 1e-4 of their
    largest element)."""
    from lemevit_tpu_torch.attn import dca, mhsa
    from lemevit_tpu_torch.models import lemevit as tmod
    counts = (ft.LAUNCHES, fb.LAUNCHES, dca.LAUNCHES, mhsa.LAUNCHES)
    torch.manual_seed(0)
    auto = tmod.LeMeViT(num_classes=10).to(cuda)
    plain = tmod.LeMeViT(num_classes=10, attn_backend="torch").to(cuda)
    plain.load_state_dict(auto.state_dict())
    x = torch.randn(2, 64, 64, 3, device=cuda)
    before = [dict(d) for d in counts]
    out = []
    for m in (auto, plain):
        m.train()
        m(x).square().mean().backward()
        m.eval()
        with torch.no_grad():
            out.append((m(x), [p.grad for p in m.parameters()]))
    torch.cuda.synchronize()
    assert [dict(d) for d in counts] == before
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(out[0][1], out[1][1]):
        if b is not None:
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-7)


# Rows 14-15 (c_train.cu's lm_c_train_fwd on k_qkv_wg, the c direction of
# k_dca_tc + k_dca_merge with the log-sum-exp and k_tail_wg's training
# instance; lm_c_attn_bwd on k_qkv_wg, k_rowmm_wg, the c direction of
# k_dca_bwd_tc and k_wgrad_tc): (N, C, batch, M, image width for the cpe
# mode or 0); a ragged N, three meta tiles, M = 320 (past the 256 meta rows
# a CTA stages at a time) and base's width
C_TRAIN_SHAPES = [(3136, 64, 2, 16, 0), (1000, 64, 2, 16, 0),
                  (784, 96, 2, 48, 0), (200, 64, 2, 320, 0),
                  (3136, 96, 2, 16, 0), (3136, 64, 2, 16, 56)]


def _c_inputs(cuda, n, ch, b, m, dtype, seed, cpe_w=0):
    """x, c, the C block's folded params, DropPath scales (some 0), the
    upstream gradient dt1c and the phases' keywords (with cpe_w, a CPE pair
    on images cpe_w wide), in dtype."""
    rng = np.random.RandomState(seed)
    hid = 4 * ch
    arrays = ([rng.randn(b, n, ch), rng.randn(b, m, ch)]
              + _lin(rng, ch, ch) + _lin(rng, 2 * ch, ch) + _lin(rng, ch, ch)
              + _lin(rng, hid, ch) + _lin(rng, ch, hid)
              + [rng.randn(b, m, ch)])
    ts = [torch.tensor(a.astype(np.float32), device=cuda).to(dtype)
          for a in arrays]
    dp = torch.from_numpy(((rng.rand(4, b) < 0.7) / 0.7).astype(
        np.float32)).to(cuda)
    kw = {"num_heads": ch // 32}
    if cpe_w:
        kw.update(cpe=[torch.tensor(a, device=cuda).to(dtype)
                       for a in _cpe(rng, ch)], img_w=cpe_w)
    return ts[0], ts[1], ts[2:12], dp, ts[12], kw


def _c_bwd_args(x, c, params, dp, dt1c, fwd):
    """The C attention backward's arguments on a forward's o and lse."""
    return (x, c, dt1c, dp, *params[:5], *fwd[2:])


def _check_phase(got, want, dtype, lse_from=None):
    """fp32 at 1e-4 of each tensor's largest element; bf16 within
    TILES_STEPS bf16 steps of it, tensors from ``lse_from`` on (the
    log-sum-exps, fp32 from rounded q and k) at 1e-3."""
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        g_, w_ = g_.float(), w_.float()
        assert g_.shape == w_.shape and torch.isfinite(g_).all(), i
        if dtype == torch.float32:
            torch.testing.assert_close(
                g_, w_, rtol=1e-4, atol=1e-4 * w_.abs().max().item(),
                msg=f"tensor {i}")
        elif lse_from is not None and i >= lse_from:
            torch.testing.assert_close(g_, w_, rtol=1e-3, atol=1e-3)
        else:
            _close_at_scale(g_, w_, None, TILES_STEPS)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,b,m,cpe_w", C_TRAIN_SHAPES)
def test_c_train_fwd_tc_matches_plain_and_tiles_model_on_gpu(cuda, n, ch, b,
                                                            m, cpe_w):
    """Row 14, lm_c_train_fwd: fp32 against c_train_fwd_plain (c_out, t1c,
    o and the meta rows' log-sum-exp); bf16 against
    c_train_fwd_tiles_plain; one launch a call; two calls give the same
    bits; in fp32 row 15 on this forward's o and log-sum-exp matches it on
    the plain forward's at 1e-4."""
    for dtype in (torch.float32, torch.bfloat16):
        x, c, params, dp, dt1c, kw = _c_inputs(cuda, n, ch, b, m, dtype, 16,
                                               cpe_w)
        before = dict(ft.LAUNCHES)
        got = ft.c_train_fwd(x, c, params, dp, **kw)
        torch.cuda.synchronize()
        assert _launched(before) == {"c_train_fwd": 1}
        again = ft.c_train_fwd(x, c, params, dp, **kw)
        for g_, a_ in zip(got, again):
            assert torch.equal(g_, a_)
        ref = (ft.c_train_fwd_plain if dtype == torch.float32
               else ft.c_train_fwd_tiles_plain)
        want = ref(x, c, params, dp, **kw)
        _check_phase(got, want, dtype, lse_from=3)
        if dtype == torch.float32:
            on_kernel = ft.c_attn_bwd(
                *_c_bwd_args(x, c, params, dp, dt1c, got), **kw)
            on_plain = ft.c_attn_bwd(
                *_c_bwd_args(x, c, params, dp, dt1c, want), **kw)
            _check_phase([t for t in on_kernel if t is not None],
                         [t for t in on_plain if t is not None], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ch,b,m,cpe_w", C_TRAIN_SHAPES)
def test_c_attn_bwd_tc_matches_plain_and_tiles_model_on_gpu(cuda, n, ch, b,
                                                           m, cpe_w):
    """Row 15, lm_c_attn_bwd: fp32 against c_attn_bwd_plain (dxt, dc, every
    weight and bias gradient, dbp among them, with the CPE the taps' and
    bias's too); bf16 against c_attn_bwd_tiles_plain; one launch a call;
    two calls give the same bits."""
    for dtype in (torch.float32, torch.bfloat16):
        x, c, params, dp, dt1c, kw = _c_inputs(cuda, n, ch, b, m, dtype, 17,
                                               cpe_w)
        args = _c_bwd_args(x, c, params, dp, dt1c,
                           ft.c_train_fwd_plain(x, c, params, dp, **kw))
        before = dict(ft.LAUNCHES)
        got = [t for t in ft.c_attn_bwd(*args, **kw) if t is not None]
        torch.cuda.synchronize()
        assert _launched(before) == {"c_attn_bwd": 1}
        again = [t for t in ft.c_attn_bwd(*args, **kw) if t is not None]
        for g_, a_ in zip(got, again):
            assert torch.equal(g_, a_)
        ref = (ft.c_attn_bwd_plain if dtype == torch.float32
               else ft.c_attn_bwd_tiles_plain)
        want = [t for t in ref(*args, **kw) if t is not None]
        assert len(got) == (10 if cpe_w else 8)
        _check_phase(got, want, dtype)
