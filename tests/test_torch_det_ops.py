"""PyTorch port, detection ops on the CPU against the JAX package:
  - ops/boxes.py (box_iou, greedy_keep, blocked_sup_matrix, nms,
    nms_indices, soft_nms, batched_nms, nms_match) and ops/rotated.py
    (obb_to_corners, quad_intersection_area, box_iou_rotated aligned and
    not, iou and iof, obb_nms batched over images, poly_iou, poly_nms,
    arb_batched_nms, convex_sort): values within 1e-5 (IoU) and keep
    masks exactly, each NMS fixture asserting that no pair's IoU lies
    within 1e-4 of its threshold, so that a flipped decision is a fault
    and not float noise;
  - ops/roi.py (roi_align v1 / aligned, roi_align_rotated, also past its
    256-roi checkpointed chunks, roi_pool, multilevel_roi_align,
    point_sample): values within 1e-5, and roi_align_rotated's gradients
    with respect to the features and to the rois within 1e-4;
  - ops/native.py: the port's own leme_ops library (built from
    ops/csrc/leme_ops.cpp) against the port's torch ops and JAX's jnp ops,
    and its fallback to the torch ops where the library is missing.
All fp32, inputs from numpy seeds."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemevit_tpu.ops import boxes as JB
from lemevit_tpu.ops import roi as JR
from lemevit_tpu.ops import rotated as JRot
from lemevit_tpu_torch.ops import boxes as B
from lemevit_tpu_torch.ops import native
from lemevit_tpu_torch.ops import roi as R
from lemevit_tpu_torch.ops import rotated as Rot

IOU_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4   # smallest distance of a decided IoU to its threshold


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=IOU_TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got),
        np.asarray(want), **tol)


def xyxy(n, seed, span=100.0):
    rs = np.random.RandomState(seed)
    lt = rs.uniform(0, span, (n, 2))
    wh = rs.uniform(5, 40, (n, 2))
    return np.concatenate([lt, lt + wh], 1).astype(np.float32)


def obbs(n, seed, span=100.0, tiny=0):
    rs = np.random.RandomState(seed)
    b = np.stack([rs.uniform(10, span, n), rs.uniform(10, span, n),
                  rs.uniform(6, 40, n), rs.uniform(6, 40, n),
                  rs.uniform(-1.5, 1.5, n)], -1).astype(np.float32)
    b[:tiny, 2] = 5e-3  # under obb_nms's min_size
    return b


def scores(n, seed):
    return np.random.RandomState(seed + 100).rand(n).astype(np.float32)


def jit(fn, **static):
    """The JAX function compiled once with its static arguments (op by op,
    a geometry function compiles hundreds of small programs)."""
    return jax.jit(functools.partial(fn, **static))


def assert_margin(iou, thr):
    """No pair decided by ``thr`` lies within MARGIN of it (the port's
    IoU, held to JAX's within 1e-5 by the tests below)."""
    iou = np.asarray(iou)
    off = ~np.eye(iou.shape[-1], dtype=bool) if iou.ndim == 2 else True
    gap = np.abs(iou - thr)[off] if iou.ndim == 2 else np.abs(iou - thr)
    assert gap.min() > MARGIN, gap.min()


# ------------------------------------------------------------- boxes

@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_box_iou(mode):
    a, b = xyxy(30, 0), xyxy(20, 1)
    close(B.box_iou(tt(a), tt(b), mode), JB.box_iou(a, b, mode))
    # leading batch dims: one call for a stack of images
    got = B.box_iou(tt(np.stack([a, a[::-1]])), tt(np.stack([b, b])), mode)
    close(got[1], JB.box_iou(a[::-1], b, mode))


def test_greedy_keep_fixpoint_batched():
    rs = np.random.RandomState(3)
    sup = rs.rand(4, 40, 40) < 0.15
    valid = rs.rand(4, 40) < 0.9
    got = B.greedy_keep(tt(sup), tt(valid))
    for i in range(4):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(JB.greedy_keep(sup[i], valid[i])))


def test_blocked_sup_matrix_blocks():
    b = xyxy(70, 4)
    got = B.blocked_sup_matrix(B.box_iou, tt(b), 0.2, block=16)
    want = JB.blocked_sup_matrix(JB.box_iou, jnp.asarray(b), 0.2, block=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("thr", [0.1, 0.3, 0.6])
def test_nms(thr):
    b, s = xyxy(60, 5), scores(60, 5)
    assert_margin(B.box_iou(tt(b), tt(b)), thr)
    want = np.asarray(jit(JB.nms, iou_threshold=thr)(b, s))
    np.testing.assert_array_equal(B.nms(tt(b), tt(s), thr).numpy(), want)
    assert 0 < want.sum() < 60
    # score threshold and tied scores: the stable order keeps JAX's pick
    s2 = np.round(s * 4) / 4
    np.testing.assert_array_equal(
        B.nms(tt(b), tt(s2), thr, score_threshold=0.3).numpy(),
        np.asarray(jit(JB.nms, iou_threshold=thr, score_threshold=0.3)(
            b, s2)))


def test_nms_indices():
    b, s = xyxy(50, 6), scores(50, 6)
    assert_margin(B.box_iou(tt(b), tt(b)), 0.3)
    idx, cnt = B.nms_indices(tt(b), tt(s), 0.3, max_outputs=20)
    jidx, jcnt = JB.nms_indices(b, s, 0.3, max_outputs=20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(cnt) == int(jcnt)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms(method):
    b, s = xyxy(40, 7), scores(40, 7)
    assert_margin(B.box_iou(tt(b), tt(b)), 0.3)
    close(B.soft_nms(tt(b), tt(s), 0.3, 0.5, method),
          jit(JB.soft_nms, iou_threshold=0.3, method=method)(b, s),
          dict(rtol=1e-5, atol=1e-6))


def test_batched_nms_and_nms_match():
    b, s = xyxy(50, 8), scores(50, 8)
    cls = np.random.RandomState(8).randint(0, 3, 50).astype(np.int32)
    assert_margin(B.box_iou(tt(b), tt(b)), 0.3)
    np.testing.assert_array_equal(
        B.batched_nms(tt(b), tt(s), tt(cls), 0.3).numpy(),
        np.asarray(JB.batched_nms(b, s, cls, 0.3)))
    np.testing.assert_array_equal(B.nms_match(tt(b), tt(s), 0.3).numpy(),
                                  np.asarray(JB.nms_match(b, s, 0.3)))


# ----------------------------------------------------------- rotated

def test_obb_to_corners():
    b = obbs(20, 9)
    close(Rot.obb_to_corners(tt(b)), JRot.obb_to_corners(b))


def test_quad_intersection_area_against_scalar_form():
    ca = np.asarray(JRot.obb_to_corners(obbs(24, 10)))
    cb = np.asarray(JRot.obb_to_corners(obbs(24, 11)))
    want = jax.jit(jax.vmap(JRot.quad_intersection_area))(ca, cb)
    close(Rot.quad_intersection_area(tt(ca), tt(cb)), want,
          dict(rtol=1e-5, atol=2e-4))
    assert (np.asarray(want) > 0).sum() >= 3


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_box_iou_rotated(mode, aligned):
    a = obbs(40, 12, span=60)
    b = obbs(40 if aligned else 25, 13, span=60)
    want = np.asarray(jit(JRot.box_iou_rotated, mode=mode,
                          aligned=aligned)(a, b))
    close(Rot.box_iou_rotated(tt(a), tt(b), mode, aligned), want)
    assert (want > 0.05).sum() >= 5
    if not aligned:  # leading batch dims: one call for every image
        got = Rot.box_iou_rotated(tt(np.stack([a, a[::-1]])),
                                  tt(np.stack([b, b])), mode)
        close(got[1], jit(JRot.box_iou_rotated, mode=mode)(a[::-1], b))


@pytest.mark.parametrize("thr", [0.1, 0.5])
def test_obb_nms_batched(thr):
    """obb_nms over a batch of images at once against JAX's vmap, with
    boxes under min_size dropped first."""
    bs = np.stack([obbs(60, 29 + i, span=80, tiny=3) for i in range(3)])
    ss = np.stack([scores(60, 29 + i) for i in range(3)])
    for bi in bs:
        assert_margin(Rot.box_iou_rotated(tt(bi), tt(bi)), thr)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x, y: JRot.obb_nms(x, y, thr)))(bs, ss))
    got = Rot.obb_nms(tt(bs), tt(ss), thr)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[:, :3].any() and want.sum() > 10


def test_obb_nms_blocked():
    """Past the 512-row block of the suppression matrix."""
    b, s = obbs(600, 17, span=1500), scores(600, 17)
    got = Rot.obb_nms(tt(b), tt(s), 0.1)
    want = np.asarray(jit(JRot.obb_nms, iou_threshold=0.1)(b, s))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 600


def poly_of(b):
    return np.asarray(JRot.obb_to_corners(b)).reshape(len(b), 8)


def test_poly_iou_and_nms():
    p = poly_of(obbs(40, 18, span=60))
    s = scores(40, 18)
    want = jax.jit(jax.vmap(JRot.poly_iou))(p[:20], p[20:])
    close(Rot.poly_iou(tt(p[:20]), tt(p[20:])), want)
    o = tt(obbs(40, 18, span=60))
    assert_margin(Rot.box_iou_rotated(o, o), 0.1)
    np.testing.assert_array_equal(Rot.poly_nms(tt(p), tt(s), 0.1).numpy(),
                                  np.asarray(jit(JRot.poly_nms,
                                                 iou_threshold=0.1)(p, s)))


@pytest.mark.parametrize("form", ["obb", "poly"])
def test_arb_batched_nms(form):
    b = obbs(50, 20, span=60)
    x = b if form == "obb" else poly_of(b)
    s = scores(50, 20)
    cls = np.random.RandomState(19).randint(0, 3, 50).astype(np.int32)
    assert_margin(Rot.box_iou_rotated(tt(b), tt(b)), 0.1)
    np.testing.assert_array_equal(
        Rot.arb_batched_nms(tt(x), tt(s), tt(cls), 0.1).numpy(),
        np.asarray(jit(JRot.arb_batched_nms, iou_threshold=0.1)(x, s, cls)))


def test_convex_sort():
    rs = np.random.RandomState(20)
    pts = rs.randn(3, 9, 2).astype(np.float32)
    masks = rs.rand(3, 9) < 0.7
    np.testing.assert_array_equal(
        Rot.convex_sort(tt(pts), tt(masks)).numpy(),
        np.asarray(JRot.convex_sort(pts, masks)))


# ---------------------------------------------------------------- roi

def feat(b=2, h=12, w=10, c=4, seed=21):
    return np.random.RandomState(seed).randn(b, h, w, c).astype(np.float32)


def aa_rois(k, seed, b=2, span=40.0):
    x = xyxy(k, seed, span)
    bi = np.random.RandomState(seed).randint(0, b, (k, 1))
    x[:3] -= 8.0  # partly outside the map: the border rule
    return np.concatenate([bi, x], 1).astype(np.float32)


def rot_rois(k, seed, b=2, span=40.0):
    o = obbs(k, seed, span)
    o[:, 2:4] /= 2
    bi = np.random.RandomState(seed).randint(0, b, (k, 1))
    return np.concatenate([bi, o], 1).astype(np.float32)


@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align(aligned):
    f, r = feat(), aa_rois(15, 22)
    close(R.roi_align(tt(f), tt(r), (3, 4), 0.25, 2, aligned),
          jit(JR.roi_align, output_size=(3, 4), spatial_scale=0.25,
              aligned=aligned)(f, r))


@pytest.mark.parametrize("aligned,clockwise", [(True, False), (False, True)])
def test_roi_align_rotated(aligned, clockwise):
    f, r = feat(), rot_rois(15, 23)
    close(R.roi_align_rotated(tt(f), tt(r), (3, 3), 0.25, 2, aligned,
                              clockwise),
          jit(JR.roi_align_rotated, output_size=(3, 3), spatial_scale=0.25,
              aligned=aligned, clockwise=clockwise)(f, r))


@pytest.mark.parametrize("k", [15, 300])
def test_roi_align_rotated_grads(k):
    """Gradients with respect to the features and to the rois' geometry
    (the sample coordinates), past the 256-roi checkpointed chunk."""
    f, r = feat(seed=24), rot_rois(k, 25)
    wgt = np.random.RandomState(26).randn(k, 3, 3, 4).astype(np.float32)

    def jloss(fj, geo):
        rj = jnp.concatenate([jnp.asarray(r[:, :1]), geo], 1)
        return (JR.roi_align_rotated(fj, rj, (3, 3), 0.25) * wgt).sum()

    jv, (jgf, jgr) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        f, r[:, 1:])
    tf = tt(f).requires_grad_()
    tg = tt(r[:, 1:].copy()).requires_grad_()
    rois = torch.cat([tt(r[:, :1]), tg], 1)
    out = R.roi_align_rotated(tf, rois, (3, 3), 0.25)
    (out * tt(wgt)).sum().backward()
    close((out * tt(wgt)).sum(), jv, dict(rtol=1e-5, atol=1e-4))
    close(tf.grad, jgf, dict(rtol=1e-4, atol=1e-4))
    close(tg.grad, jgr, dict(rtol=1e-4, atol=1e-4))
    assert np.abs(np.asarray(jgr)[:, :2]).max() > 1e-2


def test_roi_pool():
    f, r = feat(seed=27), aa_rois(8, 28, span=30)
    out, arg = R.roi_pool(tt(f), tt(r), (2, 3), 0.25)
    jout, jarg = jit(JR.roi_pool, output_size=(2, 3), spatial_scale=0.25)(
        f, r)
    close(out, jout)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))


def test_multilevel_roi_align():
    pyr = [feat(h=32 // s, w=32 // s, seed=29 + s) for s in (1, 2, 4, 8)]
    r = aa_rois(20, 30, span=200)
    r[:, 3:] = r[:, 1:3] + np.random.RandomState(31).uniform(
        10, 900, (20, 2))  # sizes across the levels
    got = R.multilevel_roi_align([tt(p) for p in pyr], tt(r), (2, 2),
                                 (4, 8, 16, 32))
    close(got, jit(JR.multilevel_roi_align, output_size=(2, 2),
                   strides=(4, 8, 16, 32))(pyr, r))


@pytest.mark.parametrize("align_corners", [False, True])
def test_point_sample(align_corners):
    f = feat(seed=32)
    pts = np.random.RandomState(33).uniform(-0.1, 1.1, (2, 17, 2)).astype(
        np.float32)
    close(R.point_sample(tt(f), tt(pts), align_corners),
          jit(JR.point_sample, align_corners=align_corners)(f, pts))


# ------------------------------------------------------------- native

def test_native_library_builds_and_loads():
    assert native.available(), native.build_error()
    assert native.version().startswith("leme_ops")
    so = native.library_path(native.SOURCE, native.BUILD_DIR)
    assert so.exists() and so.name.startswith("libleme_ops_")


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_native_box_iou_rotated(mode):
    a, b = obbs(30, 34, span=60), obbs(20, 35, span=60)
    want = np.asarray(jit(JRot.box_iou_rotated, mode=mode)(a, b))
    close(native.box_iou_rotated(a, b, mode), want, dict(rtol=1e-4,
                                                         atol=1e-4))
    close(native.box_iou_rotated(a, b, mode),
          Rot.box_iou_rotated(tt(a), tt(b), mode), dict(rtol=1e-4,
                                                        atol=1e-4))


def test_native_nms_family():
    b, s = xyxy(50, 36), scores(50, 36)
    assert_margin(B.box_iou(tt(b), tt(b)), 0.3)
    np.testing.assert_array_equal(native.nms(b, s, 0.3),
                                  B.nms(tt(b), tt(s), 0.3).numpy())
    np.testing.assert_array_equal(native.nms(b, s, 0.3),
                                  np.asarray(JB.nms(b, s, 0.3)))
    close(native.soft_nms(b, s, 0.3), B.soft_nms(tt(b), tt(s), 0.3),
          dict(rtol=1e-5, atol=1e-6))
    o = obbs(50, 37, span=80, tiny=2)
    assert_margin(Rot.box_iou_rotated(tt(o), tt(o)), 0.1)
    want = np.asarray(jit(JRot.obb_nms, iou_threshold=0.1)(o, s))
    np.testing.assert_array_equal(native.obb_nms(o, s, 0.1), want)
    np.testing.assert_array_equal(
        native.obb_nms(o, s, 0.1), Rot.obb_nms(tt(o), tt(s), 0.1).numpy())


def test_native_rejects_malformed_boxes():
    """Shapes are checked before the library reads a pointer."""
    b, o = xyxy(5, 40), obbs(5, 40)
    with pytest.raises(ValueError, match="boxes"):
        native.nms(o, scores(5, 40))
    with pytest.raises(ValueError, match="scores"):
        native.nms(b, scores(4, 40))
    with pytest.raises(ValueError, match="boxes"):
        native.box_iou_rotated(o, b)
    with pytest.raises(ValueError, match="scores"):
        native.obb_nms(o, scores(6, 40))


def test_native_falls_back_to_torch_ops(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available() and native.version() == "unavailable"
    b, s = xyxy(30, 38), scores(30, 38)
    o = obbs(30, 39, span=60)
    np.testing.assert_array_equal(native.nms(b, s, 0.3),
                                  B.nms(tt(b), tt(s), 0.3).numpy())
    close(native.soft_nms(b, s, 0.3), B.soft_nms(tt(b), tt(s), 0.3))
    close(native.box_iou_rotated(o, o[:7], "iof"),
          Rot.box_iou_rotated(tt(o), tt(o[:7]), "iof"))
    np.testing.assert_array_equal(native.obb_nms(o, s, 0.1),
                                  Rot.obb_nms(tt(o), tt(s), 0.1).numpy())
