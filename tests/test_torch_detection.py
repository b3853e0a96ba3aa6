"""PyTorch port, oriented detection on the CPU against the JAX package:
  - the coders (decode_midpoint_offset, encode_midpoint_offset,
    encode / decode_obb_deltas, canonicalize_obb, obb_to_aabb), anchors,
    the stable top-k (lax.top_k's tie order) and select_proposals with its
    -inf fillers, with and without NMS and padded: 1e-5, indices exact;
  - the training machinery (max_iou_assign on a fixture where gts share a
    best anchor and padded gts write anchor 0, sample_weights, smooth_l1,
    rpn_loss, roi_loss): assignments exact, losses 1e-5;
  - OrientedRCNN on lemevit_micro at 64 px (FPN 32 channels, 16
    proposals, per-level top 32, 3 classes) with from_jax_det weights
    (load_state_dict strict): eval outputs (keep masks and labels exact,
    boxes and scores 2e-4), train outputs 2e-4, detection_loss and its
    parts 2e-4, every parameter's gradient 5e-3, the gradient that reaches
    the RPN through the proposals, and the backbone's BatchNorm statistics;
    every fixture asserts its decisions' smallest margin to their
    thresholds, so that a flip can be told from a fault;
  - two cli.train_det --device cpu --synthetic steps (--sched step,
    --clip-grad, --weight-decay) against JAX's train_step on the same
    batches: each parameter's change within 1e-2 of JAX's largest change
    in it, BatchNorm statistics 5e-3.
JAX's OrientedRCNN compiles twice (one eval forward, one value_and_grad,
module fixtures every test reuses). All fp32, weights from numpy seeds."""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lemevit_tpu.data import create_loader as j_create_loader
from lemevit_tpu.data.detection import SyntheticDetection as JSynth
from lemevit_tpu.data.detection import detection_collate as j_collate
from lemevit_tpu.data.mixup import normalize as j_normalize
from lemevit_tpu.models import create_model as j_create_model
from lemevit_tpu.tasks import detection as JD
from lemevit_tpu.tasks import detection_train as JT
from lemevit_tpu.train.optim import mm_step_schedule as j_mm_step
from lemevit_tpu_torch.cli import train_det
from lemevit_tpu_torch.data.transforms import normalize
from lemevit_tpu_torch.models.convert import from_jax_det
from lemevit_tpu_torch.models.registry import create_model
from lemevit_tpu_torch.tasks import detection as D
from lemevit_tpu_torch.tasks import detection_train as T
from lemevit_tpu_torch.train.checkpoint import latest_checkpoint
from tests.test_torch_change_detection import _randomize
from tests.test_torch_train_model import _live_grad

KW = dict(num_classes=3, fpn_channels=32, num_proposals=16, rpn_nms_pre=32)
PX, BS, MAX_BOXES = 64, 2, 64
OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
FN_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4
# the CLI run compared with JAX: --sched step with a warmup of one
# iteration; a clip norm far below the gradients' (about 790 and 650 on the
# two batches), so that the clipped gradients come near Adam's eps and the
# update follows their size, not only their sign; a weight decay as large as
# the Adam step. A no-op step, a dropped clip or weight decay, a flipped
# sign: each misses JAX's change by more than 7 % of it (in L2 over all
# parameters), the port by about 1e-5.
CLI_LR, CLI_WD, CLI_CLIP = 1e-2, 1.0, 1e-3
# a parameter's change, against JAX's: of its largest element
STEP_TOL = 1e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got),
        np.asarray(want), **tol)


# ------------------------------------------------------------ coders

def rand_anchors(n, seed):
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(0, 100, n), rs.uniform(0, 100, n),
                     rs.uniform(8, 60, n), rs.uniform(8, 60, n)],
                    -1).astype(np.float32)


def rand_obbs(n, seed, span=100.0):
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(10, span, n), rs.uniform(10, span, n),
                     rs.uniform(6, 40, n), rs.uniform(6, 40, n),
                     rs.uniform(-3.0, 3.0, n)], -1).astype(np.float32)


def test_make_anchors():
    shapes, strides = [(4, 6), (2, 3), (1, 2)], (4, 8, 16)
    got = D.make_anchors(shapes, strides)
    for g, w in zip(got, jax.jit(lambda: JD.make_anchors(shapes, strides))()):
        close(g, w)


def test_decode_midpoint_offset():
    a = rand_anchors(64, 0)
    d = np.random.RandomState(1).randn(64, 6).astype(np.float32) * 2
    close(D.decode_midpoint_offset(tt(a), tt(d)),
          jax.jit(JD.decode_midpoint_offset)(a, d),
          dict(rtol=1e-5, atol=1e-4))


def test_encode_midpoint_offset_inverts_decode():
    a, g = rand_anchors(40, 2), rand_obbs(40, 3)
    enc = T.encode_midpoint_offset(tt(a), tt(g))
    close(enc, jax.jit(JT.encode_midpoint_offset)(a, g),
          dict(rtol=1e-5, atol=1e-5))
    # exact inverse where (da, db) lie inside the decoder's clip ranges
    inside = ((enc[:, 4] > -0.45) & (enc[:, 4] < 0.25)
              & (enc[:, 5].abs() < 0.75))
    assert inside.sum() >= 30
    back = D.decode_midpoint_offset(tt(a), enc)
    canon = T.canonicalize_obb(tt(g))
    close(back[inside], canon[inside], dict(rtol=1e-4, atol=1e-3))


def test_obb_delta_coder():
    r, g = rand_obbs(50, 4), rand_obbs(50, 5)
    enc = D.encode_obb_deltas(tt(r), tt(g))
    close(enc, jax.jit(JD.encode_obb_deltas)(r, g))
    d = np.random.RandomState(6).randn(50, 5).astype(np.float32)
    close(D.decode_obb_deltas(tt(r), tt(d)),
          jax.jit(JD.decode_obb_deltas)(r, d), dict(rtol=1e-5, atol=1e-4))


def test_canonicalize_and_aabb():
    g = rand_obbs(50, 7)
    close(T.canonicalize_obb(tt(g)), jax.jit(JT.canonicalize_obb)(g))
    close(T.obb_to_aabb(tt(g)), jax.jit(JT.obb_to_aabb)(g),
          dict(rtol=1e-5, atol=1e-4))


def test_top_k_keeps_lax_tie_order():
    """Suppressed rows at -inf are picked as fillers in index order."""
    s = np.array([[1, -np.inf, 2, -np.inf, -np.inf, 2, -np.inf]],
                 np.float32)
    want_v, want_i = jax.lax.top_k(s, 6)
    got_v, got_i = D.top_k(tt(s), 6)
    assert np.asarray(want_i).tolist() == [[2, 5, 0, 1, 3, 4]]
    assert got_i.tolist() == [[2, 5, 0, 1, 3, 4]]
    close(got_v, want_v)


def level_inputs(seed, shapes=((4, 4), (2, 2), (1, 1)), b=2, a=3):
    rs = np.random.RandomState(seed)
    cls = [rs.randn(b, h, w, a).astype(np.float32) for h, w in shapes]
    reg = [(0.3 * rs.randn(b, h, w, 6 * a)).astype(np.float32)
           for h, w in shapes]
    return cls, reg, D.make_anchors(shapes, (8, 16, 32))


@pytest.mark.parametrize("case", ["nms", "no_nms", "padded"])
def test_select_proposals(case):
    cls, reg, anchors = level_inputs(8)
    k, nms_pre = (80, 40) if case == "padded" else (20, 24)
    thr = None if case == "no_nms" else 0.5
    ja = [np.asarray(x) for x in anchors]
    want = jax.jit(functools.partial(JD.select_proposals, num_proposals=k,
                                     nms_pre=nms_pre, nms_thr=thr))(
        cls, reg, ja)
    got = D.select_proposals([tt(c) for c in cls], [tt(r) for r in reg],
                             anchors, k, nms_pre=nms_pre, nms_thr=thr)
    close(got, want, dict(rtol=1e-5, atol=1e-4))
    if case == "padded":  # 57 candidates, 80 slots: the rest are zeros
        assert (got[:, 57:] == 0).all()


# ----------------------------------------------------------- training

def test_max_iou_assign_shared_best_anchor():
    """Gts 1 and 2 share their best anchor (2 writes last and wins); gt 0
    claims anchor 0, which the padded gts 3-4 (best anchor 0 by their -1
    column) write back to its unforced values: JAX's scatter order."""
    anchors = np.array([[0, 0, 10, 10], [50, 50, 60, 60],
                        [100, 100, 112, 112], [0, 200, 30, 230],
                        [300, 300, 330, 330]], np.float32)
    gts = np.array([[[1, 1, 9, 14], [49, 48, 61, 59], [51, 52, 58, 62],
                     [0, 0, 5, 5], [0, 0, 5, 5]]], np.float32)
    mask = np.array([[True, True, True, False, False]])
    wl, wg = jax.jit(JT.max_iou_assign)(anchors, gts[0], mask[0])
    gl, gg = T.max_iou_assign(tt(anchors), tt(gts), tt(mask))
    assert gl[0].tolist() == np.asarray(wl).tolist()
    assert gg[0].tolist() == np.asarray(wg).tolist()
    assert gg[0, 1] == 2 and gl[0, 1] == 1   # the later gt wins anchor 1
    assert gl[0, 0] == -1 and gg[0, 0] == 0  # gt 0's claim undone


def test_sample_weights_and_smooth_l1():
    rs = np.random.RandomState(9)
    labels = rs.randint(-1, 2, (3, 500)).astype(np.int32)
    labels[2] = -1  # no positive, no negative
    for num, frac in ((256, 0.5), (128, 0.25)):
        gw = T.sample_weights(tt(labels), num, frac)
        for i in range(3):
            ww = JT.sample_weights(labels[i], num, frac)
            close(gw[0][i], ww[0])
            close(gw[1][i], ww[1])
    p, t = rs.randn(100).astype(np.float32), rs.randn(100).astype(np.float32)
    close(T.smooth_l1(tt(p), tt(t)), JT.smooth_l1(p, t))


def gt_batch(seed, b=2, k=6, valid=(4, 2)):
    rs = np.random.RandomState(seed)
    g = np.stack([rand_obbs(k, seed + i, span=60) for i in range(b)])
    lab = rs.randint(0, 3, (b, k)).astype(np.int32)
    mask = np.arange(k)[None] < np.asarray(valid)[:, None]
    return g, lab, mask


def test_rpn_loss():
    g, _, mask = gt_batch(10)
    anchors = np.asarray(torch.cat(D.make_anchors(
        [(8, 8), (4, 4)], (8, 16))))
    rs = np.random.RandomState(11)
    s = rs.randn(2, len(anchors)).astype(np.float32)
    d = (0.3 * rs.randn(2, len(anchors), 6)).astype(np.float32)
    got = T.rpn_loss(tt(s), tt(d), tt(anchors), tt(g), tt(mask))
    want = jax.jit(jax.vmap(JT.rpn_loss, in_axes=(0, 0, None, 0, 0)))(
        s, d, anchors, g, mask)
    for key in want:
        close(got[key], want[key])


def test_roi_loss():
    g, lab, mask = gt_batch(12)
    rois = np.stack([rand_obbs(30, 13 + i, span=60) for i in range(2)])
    rois[:, :6] = g + 1.0  # some positives
    rs = np.random.RandomState(14)
    cls = rs.randn(2, 30, 4).astype(np.float32)
    reg = (0.3 * rs.randn(2, 30, 5)).astype(np.float32)
    got = T.roi_loss(tt(cls), tt(reg), tt(rois), tt(g), tt(lab), tt(mask), 3)
    want = jax.jit(jax.vmap(functools.partial(JT.roi_loss, num_classes=3)))(
        cls, reg, rois, g, lab, mask)
    for key in want:
        close(got[key], want[key])
    assert float(got["roi_reg"].min()) > 0  # positives in both images


def test_fpn():
    rs = np.random.RandomState(15)
    feats = [rs.randn(2, 16 // s, 16 // s, c).astype(np.float32)
             for s, c in ((1, 8), (2, 16), (4, 16), (8, 24))]
    jm = JD.FPN(12, num_outs=5)
    v = {"params": _randomize(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)["params"],
        np.random.RandomState(16))}
    tm = D.FPN([8, 16, 16, 24], 12, num_outs=5)
    from lemevit_tpu_torch.models.convert import _from_tree
    tm.load_state_dict(_from_tree(v["params"], {}), strict=True)
    want = jm.apply(v, feats)
    got = tm([tt(f) for f in feats])
    assert [g.shape[1] for g in got] == [16, 8, 4, 2, 1]
    for g, w in zip(got, want):
        close(g, w, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("sched", ["cosine", "step"])
def test_schedules(sched):
    """--sched cosine against optax.warmup_cosine_decay_schedule(0, lr,
    total // 20, total), --sched step against JAX's mm_step_schedule."""
    args = train_det.build_parser().parse_args(
        ["--sched", sched, "--epochs", "12", "--warmup-iters", "7"])
    got = train_det.build_schedule(args, 10)
    want = (optax.warmup_cosine_decay_schedule(0.0, args.lr, 120 // 20, 120)
            if sched == "cosine" else j_mm_step(args.lr, 10, warmup_iters=7))
    for t in range(0, 130, 3):
        assert got(t) == pytest.approx(float(want(t)), rel=1e-5, abs=1e-9)


# ------------------------------------------------ the model against JAX

@pytest.fixture(scope="module")
def jdet():
    return JD.OrientedRCNN(
        backbone=j_create_model("lemevit_micro", features_only=True), **KW)


@pytest.fixture(scope="module")
def batches():
    """The two batches of cli.train_det --synthetic's first epoch, from
    JAX's loader and collate."""
    ds = JSynth(4 * BS, PX, KW["num_classes"])
    loader = j_create_loader(
        ds, BS, is_training=True, num_threads=1,
        collate_fn=lambda s: j_collate(s, max_boxes=MAX_BOXES))
    return [dict(b) for b, _ in zip(loader, range(2))]


@pytest.fixture(scope="module")
def variables(jdet):
    """numpy-seeded variables; the regressors scaled down and the
    classifier up, so that proposals land on the image and the class
    scores spread (the decisions then have margins)."""
    # the shapes from a trace of the train-mode init of the same model
    # without the RPN's NMS (its parameters are the same, the trace faster)
    shapes = jax.eval_shape(
        functools.partial(jdet.clone(rpn_nms=False).init, train=True),
        jax.random.PRNGKey(0), jnp.zeros((BS, PX, PX, 3)))
    rng = np.random.RandomState(0)
    v = {"params": _randomize(shapes["params"], rng),
         "batch_stats": _randomize(shapes["batch_stats"], rng, True)}
    p = v["params"]
    p["rpn"]["rpn_reg"]["kernel"] = p["rpn"]["rpn_reg"]["kernel"] * 0.1
    p["roi_head"]["reg"]["kernel"] = p["roi_head"]["reg"]["kernel"] * 0.1
    p["roi_head"]["cls"]["kernel"] = p["roi_head"]["cls"]["kernel"] * 4
    return v


def port_model(v):
    tm = D.OrientedRCNN(create_model("lemevit_micro", device="cpu",
                                     features_only=True), **KW)
    tm.load_state_dict(from_jax_det(v, tm), strict=True)
    return tm


def jax_loss_fn(jdet):
    def loss_fn(params, stats, batch):
        out, mut = jdet.apply({"params": params, "batch_stats": stats},
                              j_normalize(batch["image"]), train=True,
                              mutable=["batch_stats"])
        total, parts = JT.detection_loss(
            out, batch["gt_obbs"], batch["gt_labels"], batch["gt_mask"],
            num_classes=KW["num_classes"])
        return total, (parts, out, mut["batch_stats"])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_eval(jdet, variables, batches):
    return jax.device_get(jax.jit(
        lambda v, x: jdet.apply(v, j_normalize(x)))(
        variables, batches[0]["image"]))


@pytest.fixture(scope="module")
def jax_grad(jdet, variables, batches):
    fn = jax_loss_fn(jdet)
    (total, (parts, out, stats)), grads = fn(
        variables["params"], variables["batch_stats"], batches[0])
    return fn, jax.device_get({"total": total, "parts": parts, "out": out,
                               "stats": stats, "grads": grads})


def port_batch(b):
    return {"image": tt(b["image"]), "gt_obbs": tt(b["gt_obbs"]),
            "gt_labels": tt(b["gt_labels"]).long(),
            "gt_mask": tt(b["gt_mask"])}


def decision_margins(model, images):
    """The smallest distance of each discrete decision of a forward to its
    threshold, from the port's own intermediate values: per-level top-k
    (the scores either side of the cut), the RPN NMS IoUs against 0.8,
    the global top-K, and in eval mode the class argmax, score_thr and
    the final NMS IoUs against 0.1."""
    from lemevit_tpu_torch.ops.rotated import box_iou_rotated
    model = copy.deepcopy(model)
    out = {}
    with torch.no_grad():
        pyr = model.neck(model.backbone(normalize(images)))
        cls_scores, bbox_preds = model.rpn(pyr)
        anchors = D.make_anchors([f.shape[1:3] for f in pyr], model.strides)
        b = images.shape[0]
        gaps, ious = [], []
        for s, p, a in zip(cls_scores, bbox_preds, anchors):
            sc = s.reshape(b, -1)
            srt = torch.sort(sc, -1, descending=True).values
            kl = min(model.rpn_nms_pre, sc.shape[1])
            if kl < sc.shape[1]:
                gaps.append((srt[:, kl - 1] - srt[:, kl]).min())
            v, i = D.top_k(sc, kl)
            dec = D.decode_midpoint_offset(
                a[i], torch.take_along_dim(p.reshape(b, -1, 6), i[..., None],
                                           1))
            iou = box_iou_rotated(dec, dec)
            off = ~torch.eye(kl, dtype=torch.bool)
            ious.append((iou - model.rpn_nms_thr).abs()[:, off].min())
            gaps.append((v[:, :-1] - v[:, 1:]).min())
        out["rpn_topk"] = min(gaps)
        out["rpn_nms"] = min(ious)
        if not model.training:
            res = model(normalize(images))
            bs = res["boxes"]
            k = bs.shape[1]
            iou = box_iou_rotated(bs, bs)
            off = ~torch.eye(k, dtype=torch.bool)
            out["det_nms"] = (iou - model.nms_iou).abs()[:, off].min()
            best = res["scores"][res["keep"]]
            out["score_thr"] = (best - model.score_thr).abs().min()
    return {k: float(v) for k, v in out.items()}


def test_from_jax_det_names(variables):
    tm = port_model(variables)
    sd = tm.state_dict()
    assert "neck.lateral0.weight" in sd and "roi_head.fc1.weight" in sd
    assert "backbone.downsample_layers.0.1.running_mean" in sd
    close(sd["rpn.rpn_reg.weight"][:, :, 0, 0].T,
          variables["params"]["rpn"]["rpn_reg"]["kernel"][0, 0])


def port_forward(variables, batches, train):
    """The port's outputs on batch 0 and its decisions' margins."""
    tm = port_model(variables).train(train)
    images = tt(batches[0]["image"])
    margins = decision_margins(tm, images)
    with torch.no_grad():
        return tm(normalize(images)), margins


@pytest.fixture(scope="module")
def port_eval(variables, batches):
    return port_forward(variables, batches, False)


@pytest.fixture(scope="module")
def port_train(variables, batches):
    return port_forward(variables, batches, True)


@pytest.mark.parametrize("key", ["boxes", "scores", "labels", "keep"])
def test_eval_outputs(port_eval, jax_eval, key):
    out, margins = port_eval
    assert min(margins.values()) > MARGIN, margins
    got, want = out[key], jax_eval[key]
    if key in ("labels", "keep"):
        np.testing.assert_array_equal(got.numpy(), want)
        assert key == "labels" or 0 < want.sum() < want.size
    else:
        close(got, want, OUT_TOL)


@pytest.mark.parametrize("key", ["rpn_scores", "rpn_deltas", "anchors",
                                 "proposals", "roi_cls", "roi_reg", "rois"])
def test_train_outputs(port_train, jax_grad, key):
    out, margins = port_train
    assert min(margins.values()) > MARGIN, margins
    close(out[key], jax_grad[1]["out"][key], OUT_TOL)


def test_forward_on_given_proposals(variables, batches, port_train):
    """OrientedRCNN(images, proposals) runs the RoI head on the proposals
    given (two paths compared on the same RoIs): its own proposals give
    its own outputs."""
    out, _ = port_train
    tm = port_model(variables).train()
    with torch.no_grad():
        again = tm(normalize(tt(batches[0]["image"])), out["proposals"])
    for key in ("rois", "roi_cls", "roi_reg", "rpn_scores"):
        close(again[key], out[key])


@pytest.fixture(scope="module")
def port_step(variables, batches):
    """The port's loss and gradients on batch 0 (train mode), and the
    RPN-only part's gradient for the proposal flow."""
    tm = port_model(variables).train()
    b = port_batch(batches[0])
    out = tm(normalize(b["image"]))
    total, parts = T.detection_loss(out, b["gt_obbs"], b["gt_labels"],
                                    b["gt_mask"], KW["num_classes"])
    total.backward(retain_graph=True)
    # unreached parameters (a stage's meta-token MLP whose tokens no
    # returned map reads) get zeros, as JAX's
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in tm.named_parameters()}
    tm.zero_grad()
    (parts["rpn_cls"] + parts["rpn_reg"]).backward()
    rpn_only = tm.rpn.rpn_reg.weight.grad.clone()
    return {"total": total.detach(), "parts": parts, "grads": grads,
            "rpn_only": rpn_only, "model": tm}


def test_detection_loss(jax_grad, port_step):
    want = jax_grad[1]
    close(port_step["total"], want["total"], OUT_TOL)
    for k, v in want["parts"].items():
        close(port_step["parts"][k], v, OUT_TOL)
    assert set(port_step["parts"]) == set(want["parts"])


@pytest.mark.parametrize("group", ["backbone", "neck", "rpn", "roi_head"])
def test_gradients(variables, jax_grad, port_step, group):
    want = from_jax_det({"params": jax_grad[1]["grads"],
                         "batch_stats": variables["batch_stats"]},
                        port_step["model"])
    names = [n for n in port_step["grads"] if n.startswith(group + ".")]
    assert names
    for n in names:
        g, w = port_step["grads"][n].numpy(), want[n].numpy()
        live = _live_grad(n, g)
        np.testing.assert_allclose(g[live], w[live], err_msg=n, **GRAD_TOL)
        # structurally zero elements: rounding noise in both packages
        assert np.abs(g[~live]).max(initial=0) < 1e-2, n
        assert np.abs(w[~live]).max(initial=0) < 1e-2, n


def test_gradient_flows_through_the_proposals(variables, jax_grad, port_step):
    """The RPN's regressor gets gradient from the RoI losses through the
    proposals (sample coordinates, RoI-frame targets), in both packages:
    the total's gradient is not the RPN losses' alone."""
    want = from_jax_det({"params": jax_grad[1]["grads"],
                         "batch_stats": variables["batch_stats"]},
                        port_step["model"])["rpn.rpn_reg.weight"]
    got = port_step["grads"]["rpn.rpn_reg.weight"]
    via = got - port_step["rpn_only"]
    assert float(via.abs().max()) > 1e-3 * float(got.abs().max())
    close(via, want - port_step["rpn_only"], GRAD_TOL)


def test_batch_statistics(variables, batches, jax_grad):
    tm = port_model(variables).train()
    with torch.no_grad():
        tm(normalize(tt(batches[0]["image"])))
    want = from_jax_det({"params": variables["params"],
                         "batch_stats": jax_grad[1]["stats"]}, tm)
    sd = tm.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        close(sd[k], want[k], OUT_TOL)


def test_cli_two_steps_against_jax_train_step(variables, batches, jax_grad,
                                              monkeypatch, tmp_path):
    """cli.train_det --device cpu --synthetic, 2 steps with --sched step
    (one warmup iteration), --clip-grad and --weight-decay, from the JAX
    weights, against JAX's train_step (jax_loss_fn, optax
    clip_by_global_norm + adamw on mm_step_schedule) on the same two
    batches. Each parameter's change from the initial weights is held to
    JAX's change, within STEP_TOL of its largest element; where the exact
    gradient is structurally zero (rounding noise in both packages, see
    _live_grad) the two changes may differ by Adam's step, 2 LR at most.
    The BatchNorm statistics are held at the gradients' tolerance."""
    fn = jax_grad[0]
    sched = j_mm_step(CLI_LR, 2, warmup_iters=1)
    tx = optax.chain(optax.clip_by_global_norm(CLI_CLIP),
                     optax.adamw(sched, weight_decay=CLI_WD))
    params, stats = variables["params"], variables["batch_stats"]
    opt = tx.init(params)

    @jax.jit
    def update(g, opt, params):
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt
    for b in batches:
        (_, (_, _, stats)), g = fn(params, stats, b)
        params, opt = update(g, opt, params)
    want = from_jax_det(jax.device_get({"params": params,
                                        "batch_stats": stats}),
                        port_model(variables))

    monkeypatch.setattr(train_det, "build_model",
                        lambda args, device=None: port_model(variables))
    res = train_det.main([
        "--synthetic", "--device", "cpu", "--backbone", "lemevit_micro",
        "--img-size", str(PX), "--batch-size", str(BS), "--epochs", "1",
        "--steps-per-epoch", "2", "--num-classes", "3",
        "--fpn-channels", "32", "--num-proposals", "16",
        "--rpn-nms-pre", "32", "--sched", "step", "--warmup-iters", "1",
        "--lr", str(CLI_LR), "--weight-decay", str(CLI_WD),
        "--clip-grad", str(CLI_CLIP), "--workers", "1",
        "--output", str(tmp_path)])
    assert res["steps"] == 2 and res["best_mAP"] >= 0
    sd = torch.load(latest_checkpoint(str(tmp_path / "checkpoints")),
                    weights_only=True)["state_dict"]
    init = from_jax_det(variables, port_model(variables))
    names = {n for n, _ in port_model(variables).named_parameters()}
    assert names <= set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k not in names:
            close(sd[k], w, GRAD_TOL)
            continue
        got, dj = (sd[k] - init[k]).numpy(), (w - init[k]).numpy()
        live = _live_grad(k, dj)
        err = np.abs(got - dj)
        scale = np.abs(dj[live]).max(initial=0)
        assert scale > 0 or not live.any(), k
        assert err[live].max(initial=0) <= STEP_TOL * scale + 1e-7, (
            k, err[live].max(), scale)
        assert err[~live].max(initial=0) <= 2 * CLI_LR, k
