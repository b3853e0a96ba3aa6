"""PyTorch port, the attention-only kernels' functions (attn/dca.py,
attn/mhsa.py) on CPU tensors, through their autograd Functions (the plain
forward and the recomputed backward), against the JAX package's
pallas_dca.dca / pallas_mhsa.mhsa / sdpa in interpret mode (as
tests/test_pallas.py runs them), on numpy-seeded inputs. fp32: outputs at
rtol = atol = 1e-5, gradients at 1e-4 (tests/test_pallas.py:43-160). Also
every condition under which both packages decline, and the attention
modules' dispatch to these functions. The CUDA kernels are held against
the plain versions on the card in tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.attn import pallas_dca, pallas_mhsa
from lemevit_tpu_torch.attn import dca as tdca
from lemevit_tpu_torch.attn import mhsa as tmhsa
from lemevit_tpu_torch.attn import modules as tmodules
from lemevit_tpu_torch.attn.reference import dca_scales

H, D = 2, 32
C = H * D
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_dca, "_INTERPRET", True)
    monkeypatch.setattr(pallas_mhsa, "_INTERPRET", True)


def _arrays(seed, *lengths, b=2, c=C):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, c).astype(np.float32) for n in lengths]


def _t(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _weights(*shapes):
    """Fixed loss weights, one array per output."""
    return [np.cos(np.arange(np.prod(s), dtype=np.float32) * (i + 0.7)
                   ).reshape(s) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("n,b", [(256, 2), (1024, 1)],
                         ids=["one-tile", "two-tiles"])
def test_dca_matches_jax(n, b):
    arrs = _arrays(n, n, n, n, 16, 16, 16, b=b)
    sx, sc = dca_scales(n, 16, C)
    want = pallas_dca.dca(*map(jnp.asarray, arrs), scale_x=sx, scale_c=sc,
                          num_heads=H)
    got = tdca.dca(*_t(arrs), scale_x=sx, scale_c=sc, num_heads=H)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OUT_TOL)


def test_dca_takes_projection_views():
    """Column views of one projection output (leading dimension 3C), as
    the D module passes them, give the results of contiguous copies."""
    rng = np.random.RandomState(5)
    lin1 = torch.from_numpy(rng.randn(2, 128, 3 * C).astype(np.float32))
    lin2 = torch.from_numpy(rng.randn(2, 16, 3 * C).astype(np.float32))
    views = (*lin1.split(C, -1), *lin2.split(C, -1))
    assert tdca.rows(views[0]) == (views[0], 3 * C)
    assert tdca.rows(views[0].transpose(0, 1))[1] == C  # copied
    kw = dict(scale_x=0.1, scale_c=0.2, num_heads=H)
    got = tdca.dca(*views, **kw)
    want = tdca.dca_plain(*[v.contiguous() for v in views], **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_dca_grad_matches_jax():
    arrs = _arrays(2, 128, 128, 128, 16, 16, 16)
    sx, sc = dca_scales(128, 16, C)
    wx, wc = _weights((2, 128, C), (2, 16, C))

    def loss_jax(*a):
        xo, co = pallas_dca.dca(*a, scale_x=sx, scale_c=sc, num_heads=H)
        return (xo * wx).sum() + (co * wc).sum()

    want = jax.grad(loss_jax, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrs))
    ts = _t(arrs, grad=True)
    xo, co = tdca.dca(*ts, scale_x=sx, scale_c=sc, num_heads=H)
    ((xo * torch.from_numpy(wx)).sum()
     + (co * torch.from_numpy(wc)).sum()).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_dca_aliased_d2_matches_jax():
    """D2's dca(q, q, v1, k, k, v2): the Function returns a gradient per
    argument, and autograd sums the two of q and of k."""
    q, v1, k, v2 = _arrays(7, 128, 128, 16, 16)
    sx, sc = dca_scales(128, 16, C)
    wx, wc = _weights((2, 128, C), (2, 16, C))

    def loss_jax(q, v1, k, v2):
        xo, co = pallas_dca.dca(q, q, v1, k, k, v2, scale_x=sx, scale_c=sc,
                                num_heads=H)
        return (xo * wx).sum() + (co * wc).sum()

    jargs = [jnp.asarray(a) for a in (q, v1, k, v2)]
    want_out = pallas_dca.dca(jargs[0], jargs[0], jargs[1], jargs[2],
                              jargs[2], jargs[3], scale_x=sx, scale_c=sc,
                              num_heads=H)
    want = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*jargs)
    tq, tv1, tk, tv2 = _t((q, v1, k, v2), grad=True)
    xo, co = tdca.dca(tq, tq, tv1, tk, tk, tv2, scale_x=sx, scale_c=sc,
                      num_heads=H)
    for g, w in zip((xo, co), want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **OUT_TOL)
    ((xo * torch.from_numpy(wx)).sum()
     + (co * torch.from_numpy(wc)).sum()).backward()
    for t, w in zip((tq, tv1, tk, tv2), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("n,m,c,heads", [
    (200, 16, C, H),     # no N tile
    (256, 4, C, H),      # m % 8 != 0 (lemevit_micro's queries_len)
    (256, 16, C, 3),     # C % num_heads != 0
])
def test_dca_declines_as_jax(n, m, c, heads):
    arrs = _arrays(1, n, n, n, m, m, m, c=c)
    assert pallas_dca.dca(*map(jnp.asarray, arrs), scale_x=0.1, scale_c=0.1,
                          num_heads=heads) is None
    assert tdca.dca(*_t(arrs), scale_x=0.1, scale_c=0.1,
                    num_heads=heads) is None


@pytest.mark.parametrize("n", [196, 16])
def test_mhsa_matches_jax(n):
    q, k, v = _arrays(n, n, n, n)
    want = pallas_mhsa.mhsa(*map(jnp.asarray, (q, k, v)), num_heads=H)
    got = tmhsa.mhsa(*_t((q, k, v)), num_heads=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_mhsa_grad_matches_jax():
    q, k, v = _arrays(0, 64, 64, 64, b=1)
    (w,) = _weights((1, 64, C))

    def loss_jax(q, k, v):
        return (pallas_mhsa.mhsa(q, k, v, num_heads=H) * w).sum()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = _t((q, k, v), grad=True)
    (tmhsa.mhsa(*ts, num_heads=H) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL)


def test_sdpa_adapter_matches_jax():
    q, k, v = (a.reshape(2, 49, H, D) for a in _arrays(3, 49, 49, 49))
    want = pallas_mhsa.sdpa(*map(jnp.asarray, (q, k, v)), scale=0.3)
    got = tmhsa.sdpa(*_t((q, k, v)), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("case", ["n-over-1024", "over-budget",
                                  "heads", "cross-shape"])
def test_mhsa_declines_as_jax(case):
    if case == "n-over-1024":
        arrs, heads = _arrays(0, 1040, 1040, 1040, b=1, c=32), 1
    elif case == "over-budget":  # 4 N C 4 + 8 N^2 = 13.6 MB > 12 MiB
        arrs, heads = _arrays(0, 1024, 1024, 1024, b=1, c=320), 10
    elif case == "heads":
        arrs, heads = _arrays(0, 16, 16, 16, c=C), 3
    else:
        q, k, v = _arrays(0, 16, 64, 64)
        to4 = lambda a: a.reshape(a.shape[0], a.shape[1], H, D)  # noqa: E731
        assert pallas_mhsa.sdpa(*map(jnp.asarray, map(to4, (q, k, v)))) \
            is None
        assert tmhsa.sdpa(*_t(map(to4, (q, k, v)))) is None
        return
    assert pallas_mhsa.mhsa(*map(jnp.asarray, arrs), num_heads=heads) is None
    assert tmhsa.mhsa(*_t(arrs), num_heads=heads) is None
    assert not tmhsa.takes(arrs[0].shape[1], arrs[0].shape[2], heads, 4)


@pytest.mark.parametrize("attn_type,calls", [
    ("S", {"mhsa": 1}), ("C", {"sdpa": 1}),
    ("D", {"dca": 1}), ("D2", {"dca": 1})])
def test_modules_dispatch_to_kernel_functions(monkeypatch, attn_type, calls):
    """Each module calls its kernel function where use_kernel holds (here
    forced for CPU tensors), with the arguments the JAX modules pass, and
    gives the composition's result; under "auto" on the CPU it composes."""
    from lemevit_tpu_torch.models.lemevit import _ATTN
    seen = {"mhsa": 0, "sdpa": 0, "dca": 0}
    real = {"mhsa": tmhsa.mhsa, "sdpa": tmhsa.sdpa, "dca": tdca.dca}

    def spy(name):
        def fn(*a, **kw):
            seen[name] += 1
            if name == "dca" and attn_type == "D2":
                assert a[0] is a[1] and a[3] is a[4]  # q and k twice
            return real[name](*a, **kw)
        return fn
    monkeypatch.setattr(tmhsa, "mhsa", spy("mhsa"))
    monkeypatch.setattr(tmhsa, "sdpa", spy("sdpa"))
    monkeypatch.setattr(tdca, "dca", spy("dca"))
    torch.manual_seed(0)
    mod = _ATTN[attn_type](C, H)
    x = torch.randn(2, 64, C)
    c = torch.randn(2, 16, C)
    args = (x,) if attn_type == "S" else (x, c)
    want = mod(*args)
    assert seen == {"mhsa": 0, "sdpa": 0, "dca": 0}
    monkeypatch.setattr(tmodules, "use_kernel",
                        lambda backend, t: backend != "torch")
    got = mod(*args)
    assert {k: v for k, v in seen.items() if v} == calls
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
