"""PyTorch port, data/device_aug.py against the JAX package's
lemevit_tpu/data/device_aug.py on the JAX function's own draws.

The draws are made with jax.random exactly as ``_rrc_one``, ``aug_fn`` and
``_ra_layer_batch`` make them and handed to the port's apply functions;
inputs are numpy arrays from a seed. Limits on the [0, 255] scale: the
crop's boxes equal as integers and its resampled output within 2e-3, the
flip decisions equal, every elementwise op within 2e-3 on float input
(posterize, solarize, solarize_add, invert and equalize exact on integer
input), the warps and one whole RandAugment layer within 1e-2."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemevit_tpu.data import device_aug as J
from lemevit_tpu_torch.data import device_aug as P

RATIO = (3 / 4, 4 / 3)
EXACT_OPS = ("equalize", "invert", "posterize", "solarize", "solarize_add")
# the JAX references jitted: eager dispatch of their many small ops takes
# several times as long on the CPU
rrc_one = jax.jit(J._rrc_one, static_argnums=(2, 3, 4, 5))
ra_layer_batch = jax.jit(J._ra_layer_batch, static_argnums=(2, 3))
warp_pm = jax.jit(J._warp_pm, static_argnums=(1, 2, 3, 4, 5))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_rrc_draws(key, b, scale=(0.08, 1.0), ratio=RATIO):
    """aug_fn's per-image keys split as _rrc_one splits them: the (B, 10)
    area fractions and log ratios, (B, 2) offsets and (B,) flip uniforms,
    beside each image's crop key."""
    keys = jax.random.split(key, b)
    area, log_ratio, xy, flip, crop_keys = [], [], [], [], []
    for k in keys:
        k_crop, k_flip = jax.random.split(k)
        k_area, k_ratio, k_xy = jax.random.split(k_crop, 3)
        area.append(jax.random.uniform(k_area, (10,), minval=scale[0],
                                       maxval=scale[1]))
        log_ratio.append(jax.random.uniform(
            k_ratio, (10,), minval=math.log(ratio[0]),
            maxval=math.log(ratio[1])))
        xy.append(jax.random.uniform(k_xy, (2,)))
        flip.append(jax.random.uniform(k_flip))
        crop_keys.append(k_crop)
    return ([t(np.stack([np.asarray(v) for v in vals]))
             for vals in (area, log_ratio, xy, flip)], crop_keys)


def jax_layer_draws(key, b, magnitude=9.0, mag_std=0.5):
    """_ra_layer_batch's (perm, magnitudes, sign uniforms) of ``key``."""
    k_perm, k_mag, k_sign = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(k_perm, b))
    mags = np.asarray(jnp.clip(
        magnitude + mag_std * jax.random.normal(k_mag, (b,)), 0.0, 10.0))
    return t(perm).long(), t(mags), t(np.asarray(
        jax.random.uniform(k_sign, (b,))))


def jax_box(key, s, scale=(0.08, 1.0), ratio=RATIO):
    """The box _rrc_one crops with ``key`` (its lines, up to the resample)."""
    k_area, k_ratio, k_xy = jax.random.split(key, 3)
    areas = s * s * jax.random.uniform(k_area, (10,), minval=scale[0],
                                       maxval=scale[1])
    aspects = jnp.exp(jax.random.uniform(
        k_ratio, (10,), minval=math.log(ratio[0]), maxval=math.log(ratio[1])))
    cws = jnp.round(jnp.sqrt(areas * aspects))
    chs = jnp.round(jnp.sqrt(areas / aspects))
    valid = (cws > 0) & (cws <= s) & (chs > 0) & (chs <= s)
    first = jnp.argmax(valid)
    cw = jnp.where(valid.any(), cws[first], float(s))
    ch = jnp.where(valid.any(), chs[first], float(s))
    u, v = jax.random.uniform(k_xy, (2,))
    return [int(x) for x in (jnp.floor(u * (s - cw + 1)),
                             jnp.floor(v * (s - ch + 1)), cw, ch)]


def images(b, s, seed=0, integer=False):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 255, (b, s, s, 3)).astype(np.float32)
    return np.round(x) if integer else x


@pytest.mark.parametrize("integer", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("op", [f.__name__ for f in P.EW_OPS])
def test_elementwise_op(op, integer):
    rs = np.random.RandomState(3)
    b = 12
    mags = rs.uniform(0, 10, b).astype(np.float32)
    mags[:2] = (0.0, 10.0)
    us = rs.uniform(0, 1, b).astype(np.float32)
    x = images(b, 33, seed=4, integer=integer)
    x[0] = 17.0  # a flat image: autocontrast's and equalize's identity
    jop = J._EW_OPS[[f.__name__ for f in P.EW_OPS].index(op)]
    want = np.asarray(jax.jit(jax.vmap(jop))(
        jnp.asarray(x), jnp.asarray(mags), jnp.asarray(us)))
    got = getattr(P, op)(t(x), t(mags), t(us)).numpy()
    err = np.abs(got - want).max()
    if integer and op in EXACT_OPS:
        assert err == 0, err
    assert err <= 2e-3, err


@pytest.mark.parametrize("s,out,scale,ratio,seed", [
    (48, 32, (0.08, 1.0), RATIO, 0),
    (40, 48, (0.08, 1.0), RATIO, 1),   # crops upsampled
    (37, 16, (0.5, 1.0), RATIO, 2),    # odd side, shrinking
    (32, 24, (0.9, 1.0), (8.0, 9.0), 3)])  # no box fits: the square
def test_rrc_boxes_and_crop(s, out, scale, ratio, seed):
    b = 10
    x = images(b, s, seed=seed)
    key = jax.random.PRNGKey(seed)
    (area, log_ratio, xy, _), crop_keys = jax_rrc_draws(key, b, scale, ratio)
    got_box = torch.stack(P.rrc_boxes(s, area, log_ratio, xy), 1)
    want_box = [jax_box(k, s, scale, ratio) for k in crop_keys]
    assert got_box.to(torch.int64).tolist() == want_box
    assert torch.equal(got_box, got_box.round())
    want = np.stack([np.asarray(rrc_one(k, jnp.asarray(im), out, scale,
                                        ratio, "cubic"))
                     for k, im in zip(crop_keys, x)])
    got = P.rrc_apply(t(x), out, area, log_ratio, xy).numpy()
    assert got.shape == (b, out, out, 3)
    assert np.abs(got - want).max() <= 2e-3


def test_crop_and_flip_match_aug_fn():
    """DeviceAug with no RandAugment: the flip decisions are JAX's,
    and each flipped image is the mirror of its crop."""
    b, s, out = 16, 40, 32
    x = np.random.RandomState(5).randint(0, 256, (b, s, s, 3)).astype(
        np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(J.make_train_aug(out, auto_augment=None))(
        key, jnp.asarray(x)))
    (area, log_ratio, xy, flip), _ = jax_rrc_draws(key, b)
    aug = P.DeviceAug(out, auto_augment=None)
    draws = P.AugDraws(area, log_ratio, xy, flip, ())
    got = aug.apply(t(x), draws).numpy()
    assert np.abs(got - want).max() <= 2e-3
    crops = np.clip(P.rrc_apply(t(x).float(), out, area, log_ratio,
                                xy).numpy(), 0, 255)
    flipped = (flip < 0.5).numpy()
    assert 0 < flipped.sum() < b
    assert np.array_equal(got[flipped], crops[flipped][:, :, ::-1])
    assert np.array_equal(got[~flipped], crops[~flipped])


@pytest.mark.parametrize("op", [0, 1, 2])
@pytest.mark.parametrize("level", [8.5, 9.0, 9.5])
def test_warp_against_jax(op, level):
    """Rotate / shear x / shear y at one level, the first 3 images at sign
    +1, the rest at -1 (JAX: one warp, the signs merged by mirroring)."""
    h, w, n_pos = 24, 30, 3
    x = np.random.RandomState(op).uniform(0, 255, (5, h, w, 3)).astype(
        np.float32)
    want = np.asarray(warp_pm(jnp.asarray(x), op, level, n_pos, h, w))
    mats = torch.tensor([P.geo_matrix(op, 1.0 if i < n_pos else -1.0, level,
                                      h, w) for i in range(5)],
                        dtype=torch.float32)
    got = P.affine_warp(t(x), mats).numpy()
    assert np.abs(got - want).max() <= 1e-2


@pytest.mark.parametrize("op", [3, 4])
def test_translate_is_exact(op):
    h, w = 20, 28
    x = np.round(np.random.RandomState(op).uniform(0, 255, (6, h, w, 3))
                 ).astype(np.float32)
    shifts = [P.translate_px(op, sign, lvl, h, w)
              for sign in (1.0, -1.0) for lvl in (0.0, 8.5, 10.0)]
    axis = 2 if op == 3 else 1
    want = np.stack([np.asarray(J._translate_px(jnp.asarray(im[None]), sh,
                                                axis))[0]
                     for im, sh in zip(x, shifts)])
    sh = torch.tensor(shifts)
    zero = torch.zeros_like(sh)
    got = P.shift_images(t(x), sh if op == 3 else zero,
                         zero if op == 3 else sh).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("b,seed", [(30, 7), (17, 8)])
def test_ra_layer_against_jax(b, seed):
    """One whole layer on JAX's permutation, magnitudes and signs: 30
    images give every op two slots and every geometric variant its own."""
    x = images(b, 32, seed=seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(ra_layer_batch(key, jnp.asarray(x), 9.0, 0.5))
    got = P.ra_layer(t(x), *jax_layer_draws(key, b), 9.0, 0.5).numpy()
    assert np.abs(got - want).max() <= 1e-2


def test_layer_plan_is_jaxs_stratified_split():
    plan = P.layer_plan(30, 9.0, 0.5)
    counts = J._balanced_split(30, J._N_OPS)
    assert [sum(p[0] == op for p in plan) for op in range(P.N_OPS)] == counts
    assert P.GEO_VARIANTS == J._GEO_VARIANTS
    for op in range(J._N_GEO):
        sub = J._balanced_split(counts[op], len(J._GEO_VARIANTS))
        want = [(s, min(10.0, 9.0 + 0.5 * lv))
                for (s, lv), n in zip(J._GEO_VARIANTS, sub) for _ in range(n)]
        assert [p[1:] for p in plan if p[0] == op] == want
    # ops in slot order: the geometric ones first, then the elementwise
    assert [p[0] for p in plan] == sorted(p[0] for p in plan)


def test_whole_pipeline_against_aug_fn():
    """DeviceAug against JAX's make_train_aug, default policy (crop, flip,
    two RandAugment layers), on JAX's draws of one key."""
    b, s, out = 16, 40, 32
    x = np.random.RandomState(9).randint(0, 256, (b, s, s, 3)).astype(
        np.uint8)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax.jit(J.make_train_aug(out))(key, jnp.asarray(x)))
    (area, log_ratio, xy, flip), _ = jax_rrc_draws(key, b)
    k_ra = jax.random.fold_in(key, 0x5A)
    layers = tuple(jax_layer_draws(jax.random.fold_in(k_ra, i), b)
                   for i in range(2))
    got = P.DeviceAug(out).apply(
        t(x), P.AugDraws(area, log_ratio, xy, flip, layers)).numpy()
    assert got.shape == want.shape == (b, out, out, 3)
    assert np.abs(got - want).max() <= 1e-2


def test_draws_come_from_the_generator():
    """draw() takes every random number from the generator it is given:
    the same seed gives the same draws and output, shapes and ranges as
    the apply functions take them."""
    aug = P.DeviceAug(24, scale=(0.25, 0.5))
    x = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (6, 32, 32, 3)).astype(np.uint8))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(4)
        d = aug.draw(gen, 6, x.device)
        outs.append(aug.apply(x, d))
    assert torch.equal(outs[0], outs[1])
    assert d.area.shape == d.log_ratio.shape == (6, 10)
    assert 0.25 <= d.area.min() and d.area.max() < 0.5
    assert math.log(3 / 4) <= d.log_ratio.min() < d.log_ratio.max() <= \
        math.log(4 / 3)
    assert len(d.layers) == 2 and sorted(d.layers[0][0].tolist()) == \
        list(range(6))
    assert all(0 <= m.min() and m.max() <= 10 for _, m, _ in d.layers)
    assert outs[0].shape == (6, 24, 24, 3) and outs[0].dtype == torch.float32
    assert outs[0].is_contiguous()
    plain = P.DeviceAug(24, auto_augment=None)(gen, x)
    assert plain.is_contiguous() and plain.shape == outs[0].shape
    assert 0 <= outs[0].min() and outs[0].max() <= 255
    assert torch.equal(aug(torch.Generator().manual_seed(4), x), outs[0])


@pytest.mark.parametrize("aa", ["rand-m9-mstd0.5-inc1", "rand-n3-m7",
                                "rand-m5-mstd1.0-n1", "", None])
def test_parse_rand_augment(aa):
    assert P.parse_rand_augment(aa) == J.parse_rand_augment(aa)


def test_non_rand_policies_raise():
    for aa in ("augmix-m3-w3", "original"):
        with pytest.raises(ValueError, match="rand-"):
            P.DeviceAug(32, auto_augment=aa)


@pytest.mark.parametrize("s,size", [(40, 35), (32, 48), (36, 36)])
def test_resize_and_center_crop(s, size):
    """validate's packed eval: jax.image.resize(..., "bicubic") then the
    centre crop."""
    x = images(3, s, seed=s)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, size, size, 3),
                                       "bicubic"))
    got = P.resize_square(t(x), size)
    assert got.is_contiguous()  # the block kernels take only these
    got = got.numpy()
    assert np.abs(got - want).max() <= 2e-3
    crop = min(size, 30)
    assert np.array_equal(
        P.center_crop(t(got), crop).numpy(),
        np.asarray(J.center_crop(jnp.asarray(got), crop)))
    with pytest.raises(ValueError, match="packed px"):
        P.center_crop(t(x), s + 1)
