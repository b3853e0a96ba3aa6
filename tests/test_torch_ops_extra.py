"""PyTorch port, the rest of ops/ against the JAX package on the CPU:
  - the four corner pools (ops/pooling.py): values exactly; gradients
    1e-6 on a fixture with ties (integer maps of few values, where
    ``lax.cummax``'s associative-scan gradient halves at every tie and
    ``torch.cummax``'s own would go to one index) and on one without;
  - masked_conv2d (NHWC, HWIO, both mask ranks, bias, stride): 1e-5;
  - ORN (ops/orn.py): the index table exactly, active_rotating_filter,
    orconv2d with its bias, rotation_invariant_encoding / _pooling, and
    the gradients through the filter gather: 1e-5;
  - the plugins (ops/plugins.py): ContextBlock, NonLocal2D,
    GeneralizedAttention, SumCell and GlobalPoolingCell in their
    configurations, on parameters perturbed from a seed (the flax modules
    zero-initialise layers, NonLocal2D is the identity at init), carried
    across by models/convert.py::from_jax_plugin: outputs 1e-5, the merge
    cells' BatchNorm statistics in train mode; the registry and the
    port's own init (NonLocal2D the identity)."""
import numpy as np
import pytest
import torch

import jax

from lemevit_tpu import ops as J
from lemevit_tpu.ops import orn as JO
from lemevit_tpu_torch import ops as P
from lemevit_tpu_torch.models.convert import from_jax_plugin
from lemevit_tpu_torch.ops import orn as PO
from lemevit_tpu_torch.ops import plugins as PP
from tests.test_torch_change_detection import _randomize

TOL = dict(rtol=1e-5, atol=1e-5)
DIRECTIONS = ["top", "bottom", "left", "right"]


def tt(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got),
        np.asarray(want), **tol)


# ------------------------------------------------------------ pooling

def pool_grads(direction, x, g):
    want = jax.grad(lambda a: (J.corner_pool(a, direction) * g).sum())(x)
    t = tt(x).requires_grad_()
    out = P.corner_pool(t, direction)
    (out * tt(g)).sum().backward()
    return out, t.grad, want


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
def test_corner_pool(direction, ties):
    rs = np.random.RandomState(DIRECTIONS.index(direction) + 4 * ties)
    shape = (2, 7, 9, 3)
    x = (rs.randint(0, 3, shape) if ties else rs.randn(*shape)).astype(
        np.float32)
    g = rs.randn(*shape).astype(np.float32)
    out, grad, want = pool_grads(direction, x, g)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  J.corner_pool(x, direction))
    close(grad, want, dict(rtol=1e-6, atol=1e-6))
    fn = getattr(P, f"{direction}_pool")
    np.testing.assert_array_equal(fn(tt(x)).numpy(), out.detach().numpy())
    # torch.cummax's own gradient: all of it to the index it returns
    axis, reverse = {"top": (1, True), "bottom": (1, False),
                     "left": (2, True), "right": (2, False)}[direction]
    t = tt(x).requires_grad_()
    v = t.flip(axis) if reverse else t
    c = torch.cummax(v, axis).values
    ((c.flip(axis) if reverse else c) * tt(g)).sum().backward()
    split = not np.allclose(t.grad.numpy(), np.asarray(want), atol=1e-6)
    assert split == ties  # the fixture has ties where the two differ


def test_masked_conv2d():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 9, 8, 3).astype(np.float32)
    k = rs.randn(3, 3, 3, 4).astype(np.float32)
    bias = rs.randn(4).astype(np.float32)
    for stride, pad in ((1, 1), (2, 0)):
        ho = (9 + 2 * pad - 3) // stride + 1
        wo = (8 + 2 * pad - 3) // stride + 1
        mask = rs.rand(2, ho, wo) > 0.5
        for m, b in ((mask, None), (mask[..., None], bias)):
            got = P.masked_conv2d(tt(x), tt(m), tt(k), None if b is None
                                  else tt(b), stride, pad)
            close(got, J.masked_conv2d(x, m, k, b, stride, pad))
            assert (got.numpy()[~mask] == 0).all()


# ---------------------------------------------------------------- ORN

@pytest.mark.parametrize("k, n_orient, n_rot", [(3, 8, 8), (3, 4, 4),
                                                (1, 8, 8), (5, 8, 4)])
def test_arf_indices(k, n_orient, n_rot):
    np.testing.assert_array_equal(PO._arf_indices(k, n_orient, n_rot),
                                  JO._arf_indices(k, n_orient, n_rot))


def test_active_rotating_filter_and_orconv2d():
    rs = np.random.RandomState(6)
    w = rs.randn(4, 2, 8, 3, 3).astype(np.float32)
    close(P.active_rotating_filter(tt(w), 8), J.active_rotating_filter(w, 8))
    close(P.active_rotating_filter(tt(w), 4), J.active_rotating_filter(w, 4))
    x = rs.randn(2, 6, 7, 16).astype(np.float32)
    bias = rs.randn(4).astype(np.float32)
    close(P.orconv2d(tt(x), tt(w), tt(bias)), J.orconv2d(x, w, bias))
    close(P.orconv2d(tt(x), tt(w), stride=2, padding=0),
          J.orconv2d(x, w, stride=2, padding=0))
    g = rs.randn(2, 6, 7, 32).astype(np.float32)
    want = jax.grad(lambda a: (J.orconv2d(x, a, bias) * g).sum())(w)
    t = tt(w).requires_grad_()
    (P.orconv2d(tt(x), t, tt(bias)) * tt(g)).sum().backward()
    close(t.grad, want, dict(rtol=1e-5, atol=1e-4))


def test_rotation_invariant_encoding_and_pooling():
    rs = np.random.RandomState(7)
    x = rs.randint(0, 4, (2, 3, 4, 24)).astype(np.float32)  # with ties
    close(P.rotation_invariant_encoding(tt(x), 8),
          J.rotation_invariant_encoding(x, 8))
    close(P.rotation_invariant_pooling(tt(x)), J.rotation_invariant_pooling(x))
    close(P.rotation_invariant_pooling(tt(x), 4),
          J.rotation_invariant_pooling(x, 4))
    g = rs.randn(2, 3, 4, 3).astype(np.float32)
    want = jax.grad(lambda a: (J.rotation_invariant_encoding(a, 8)
                               * g).sum())(x)
    t = tt(x).requires_grad_()
    (P.rotation_invariant_encoding(t, 8) * tt(g)).sum().backward()
    close(t.grad, want)


# ------------------------------------------------------------ plugins

PLUGINS = {
    "context_att_add": (J.ContextBlock, PP.ContextBlock,
                        dict(in_channels=16), (2, 8, 8, 16)),
    "context_avg_mul_add": (J.ContextBlock, PP.ContextBlock,
                            dict(in_channels=16, ratio=0.25,
                                 pooling_type="avg",
                                 fusion_types=("channel_add",
                                               "channel_mul")),
                            (2, 6, 5, 16)),
    "nonlocal_embedded": (J.NonLocal2D, PP.NonLocal2D,
                          dict(in_channels=8), (1, 6, 6, 8)),
    "nonlocal_dot_sub": (J.NonLocal2D, PP.NonLocal2D,
                         dict(in_channels=8, mode="dot_product",
                              sub_sample=True), (2, 6, 8, 8)),
    "nonlocal_gaussian": (J.NonLocal2D, PP.NonLocal2D,
                          dict(in_channels=8, mode="gaussian"),
                          (1, 5, 6, 8)),
    "generalized": (J.GeneralizedAttention, PP.GeneralizedAttention,
                    dict(in_channels=18, num_heads=3, kv_stride=2),
                    (1, 8, 8, 18)),
    "generalized_qstride": (J.GeneralizedAttention, PP.GeneralizedAttention,
                            dict(in_channels=12, num_heads=2, kv_stride=1,
                                 q_stride=2, position_embedding_dim=10),
                            (2, 7, 6, 12)),
}


def jax_plugin(jcls, kw, *inputs, static=(), seed=0):
    """The JAX module and numpy-seeded variables on the shapes of its
    init on ``inputs`` (``static``: further arguments, not traced)."""
    m = jcls(**kw)
    shapes = jax.eval_shape(lambda *a: m.init(jax.random.PRNGKey(0), *a,
                                              *static), *inputs)
    rng = np.random.RandomState(seed)
    v = {"params": _randomize(shapes["params"], rng)}
    if "batch_stats" in shapes:
        v["batch_stats"] = _randomize(shapes["batch_stats"], rng, True)
    return m, v


@pytest.mark.parametrize("case", list(PLUGINS))
def test_plugin(case):
    jcls, pcls, kw, shape = PLUGINS[case]
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    jm, v = jax_plugin(jcls, kw, x)
    pm = pcls(**kw).eval()
    pm.load_state_dict(from_jax_plugin(v), strict=True)
    got = pm(tt(x))
    want = jm.apply(v, x)
    close(got, want)
    assert float(np.abs(np.asarray(want) - x).max()) > 1e-2  # not identity


@pytest.mark.parametrize("cell", ["SumCell", "GlobalPoolingCell"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_merge_cells(cell, train):
    rs = np.random.RandomState(9)
    a = rs.randn(2, 8, 8, 8).astype(np.float32)
    b = rs.randn(2, 4, 4, 8).astype(np.float32)
    for out_size in (None, (4, 4), (6, 10)):
        jm, v = jax_plugin(getattr(J, cell), dict(out_channels=6), a, b,
                           static=(out_size,))
        pm = getattr(PP, cell)(6, in_channels=8).train(train)
        pm.load_state_dict(from_jax_plugin(v), strict=True)
        with torch.no_grad():
            got = pm(tt(a), tt(b), out_size)
        if train:
            want, mut = jm.apply(v, a, b, out_size, train=True,
                                 mutable=["batch_stats"])
            sd = pm.state_dict()
            close(sd["bn.running_mean"], mut["batch_stats"]["bn"]["mean"])
            close(sd["bn.running_var"], mut["batch_stats"]["bn"]["var"])
        else:
            want = jm.apply(v, a, b, out_size)
        close(got, want)


def test_plugin_registry_and_init():
    name, mod = P.build_plugin_layer(dict(type="ContextBlock",
                                          in_channels=8))
    assert name == "contextblock" and isinstance(mod, PP.ContextBlock)
    assert set(P.PLUGIN_LAYERS) == {"ContextBlock", "NonLocal2D",
                                    "GeneralizedAttention"}
    x = torch.randn(1, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    assert mod(x).shape == x.shape
    with pytest.raises(KeyError, match="unknown plugin"):
        P.build_plugin_layer(dict(type="NopeBlock"))

    @PP.register_plugin("TwiceBlock")
    class TwiceBlock(torch.nn.Module):
        def forward(self, t):
            return 2 * t
    try:
        name, mod = P.build_plugin_layer(dict(type="TwiceBlock"))
        assert name == "twiceblock" and torch.equal(mod(x), 2 * x)
    finally:
        del PP.PLUGIN_LAYERS["TwiceBlock"]
    # flax's initialisers: NonLocal2D's conv_out zero (the identity at
    # init), from an explicit generator, the same draws for the same seed
    nl = PP.NonLocal2D(8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(nl(x), x)
    a, b = (PP.GeneralizedAttention(18, 3, generator=torch.Generator(
        ).manual_seed(1)) for _ in range(2))
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    std = float(a.query.weight.detach().std())
    assert 0.5 / np.sqrt(18) < std < 1.5 / np.sqrt(18)
    assert not a.query.bias.any()
