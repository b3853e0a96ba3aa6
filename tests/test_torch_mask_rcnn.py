"""PyTorch port, Mask R-CNN on the CPU against the JAX package:
  - the box coder (encode_boxes / decode_boxes, xyxy_to_xywh) and the
    mask head's 2x2 stride-2 transposed conv against flax's
    ConvTranspose: 1e-5;
  - MaskRCNN on lemevit_micro at 64 px (5 classes, FPN 16, 8 proposals,
    RoI 4, mask RoI 4: tests/test_mask_rcnn.py's model) with
    from_jax_maskrcnn weights (load_state_dict strict): the eval outputs
    (keep masks and labels exact, boxes, scores and masks 2e-4), the train
    outputs 2e-4, mask_rcnn_loss's five parts on JAX's own train outputs
    (so that no proposal pick can hide a loss fault) and on the port's,
    2e-4, every parameter's gradient 5e-3, the gradient that reaches the
    RPN through the proposals, and the backbone's BatchNorm statistics;
  - two cli.train_maskrcnn --device cpu --synthetic steps (--sched step,
    --clip-grad, --weight-decay) against JAX's train step on the same
    batches: the parameters' change from the initial weights against
    JAX's in L2, over all parameters 1e-2, each tensor 5e-2 (the settings of
    tests/test_torch_detection.py's CLI test).
The ground truth is made from the model's own proposals (each image's gts
are three of its proposals, moved by up to 1.5 px, with elliptic masks),
so that the RoI and mask losses have positives. Every fixture asserts the
smallest margin of its decisions to their thresholds, so that a flip can
be told from a fault. JAX's MaskRCNN compiles twice (one eval forward, one
value_and_grad), in module fixtures. All fp32, weights from numpy seeds."""
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from lemevit_tpu.data import create_loader as j_create_loader
from lemevit_tpu.data.coco import instance_collate as j_collate
from lemevit_tpu.data.mixup import normalize as j_normalize
from lemevit_tpu.models import create_model as j_create_model
from lemevit_tpu.tasks import mask_rcnn as JM
from lemevit_tpu.train.optim import mm_step_schedule as j_mm_step
from lemevit_tpu_torch.cli import train_maskrcnn
from lemevit_tpu_torch.data import coco as port_coco
from lemevit_tpu_torch.data.transforms import normalize
from lemevit_tpu_torch.models.convert import _from_tree, from_jax_maskrcnn
from lemevit_tpu_torch.models.registry import create_model
from lemevit_tpu_torch.ops.boxes import box_iou
from lemevit_tpu_torch.ops.roi import roi_align
from lemevit_tpu_torch.tasks import mask_rcnn as M
from lemevit_tpu_torch.tasks.snunet import conv_transpose_same
from lemevit_tpu_torch.train.checkpoint import latest_checkpoint
from tests.test_torch_change_detection import _randomize
from tests.test_torch_detection import CLI_CLIP, CLI_LR, CLI_WD, STEP_TOL
from tests.test_torch_train_model import _live_grad

KW = dict(num_classes=5, fpn_channels=16, num_proposals=8, roi_size=4,
          mask_roi_size=4)
PX, BS, N_IMG, MAX_BOXES, N_GT = 64, 2, 8, 4, 3
OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
FN_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4
# the CLI's change of one tensor against JAX's, in L2: not element by
# element, since ReLU units whose input lies within float noise of zero
# (there are such units in every head at these sizes) switch between the
# packages, or between one and four CPU threads, and move single elements
# of the mask head's small gradients by up to 12 % of the tensor's largest
# change, its L2 by under 1 %
TENSOR_STEP_TOL = 5e-2
PARTS = ("rpn_cls", "rpn_reg", "roi_cls", "roi_reg", "mask")


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

def test_box_coder():
    rs = np.random.RandomState(0)
    anchors = np.stack([rs.uniform(20, 80, 40), rs.uniform(20, 80, 40),
                        rs.uniform(8, 30, 40), rs.uniform(8, 30, 40)],
                       -1).astype(np.float32)
    gt = np.stack([rs.uniform(10, 40, 40), rs.uniform(10, 40, 40),
                   rs.uniform(50, 90, 40), rs.uniform(50, 90, 40)],
                  -1).astype(np.float32)
    enc = M.encode_boxes(tt(anchors), tt(gt))
    close(enc, jax.jit(JM.encode_boxes)(anchors, gt))
    close(M.decode_boxes(tt(anchors), enc), gt, dict(rtol=1e-4, atol=1e-3))
    d = (3 * rs.randn(40, 4)).astype(np.float32)  # past the +-4 clip
    close(M.decode_boxes(tt(anchors), tt(d)),
          jax.jit(JM.decode_boxes)(anchors, d), dict(rtol=1e-5, atol=1e-4))
    close(M.xyxy_to_xywh(tt(gt)), jax.jit(JM._xyxy_to_xywh)(gt))


@pytest.mark.parametrize("k", [2, 3])
def test_conv_transpose_same(k):
    """flax's ConvTranspose (stride 2, "SAME", unflipped) at the mask
    head's 2x2 and SNUNet's 3x3, with the kernel from_jax converts."""
    jm = fnn.ConvTranspose(5, (k, k), strides=(2, 2))
    x = np.random.RandomState(k).randn(2, 4, 6, 3).astype(np.float32)
    v = {"params": _randomize(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), x)["params"],
        np.random.RandomState(1))}
    conv = torch.nn.Conv2d(3, 5, k)
    conv.load_state_dict(_from_tree(v["params"], {}), strict=True)
    got = conv_transpose_same(conv, tt(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1), jm.apply(v, x))


# ------------------------------------------------ the model against JAX

@pytest.fixture(scope="module")
def jm():
    return JM.MaskRCNN(
        backbone=j_create_model("lemevit_micro", features_only=True), **KW)


@pytest.fixture(scope="module")
def variables(jm):
    """numpy-seeded variables; the regressors scaled down and the
    classifier up, so that proposals land on the image and the class
    scores spread (the decisions then have margins)."""
    shapes = jax.eval_shape(functools.partial(jm.init, train=True),
                            jax.random.PRNGKey(0), jnp.zeros((BS, PX, PX, 3)))
    rng = np.random.RandomState(0)
    v = {"params": _randomize(shapes["params"], rng),
         "batch_stats": _randomize(shapes["batch_stats"], rng, True)}
    p = v["params"]
    p["rpn"]["rpn_reg"]["kernel"] = p["rpn"]["rpn_reg"]["kernel"] * 0.1
    p["box_head"]["reg"]["kernel"] = p["box_head"]["reg"]["kernel"] * 0.1
    p["box_head"]["cls"]["kernel"] = p["box_head"]["cls"]["kernel"] * 2
    return v


def jax_loss_fn(jm):
    def loss_fn(params, stats, batch):
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            j_normalize(batch["image"]), train=True,
                            mutable=["batch_stats"])
        total, parts = JM.mask_rcnn_loss(
            out, batch["gt_boxes"], batch["gt_labels"], batch["gt_masks"],
            batch["gt_valid"], num_classes=KW["num_classes"])
        return total, (parts, out, mut["batch_stats"])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


class Crafted:
    """N_IMG random images with ground truth made from proposals: the
    dataset cli.train_maskrcnn gets in place of SyntheticInstanceSeg."""

    def __init__(self, images, gts):
        self.images, self.gts = images, gts

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return (self.images[i], *self.gts[i])


def gts_from_proposals(props, rs):
    """Three of an image's proposals, each moved by up to 1.5 px and
    clipped to the image, as gt boxes with random labels and an elliptic
    mask inside each box."""
    pick = rs.choice(len(props), N_GT, replace=False)
    boxes = props[pick] + rs.uniform(-1.5, 1.5, (N_GT, 4))
    boxes = np.clip(boxes, 0, PX).astype(np.float32)
    labels = rs.randint(0, KW["num_classes"], N_GT).astype(np.int32)
    yy, xx = np.mgrid[:PX, :PX] + 0.5
    cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    rx = (boxes[:, 2] - boxes[:, 0]) / 2 * rs.uniform(0.6, 1.0, N_GT)
    ry = (boxes[:, 3] - boxes[:, 1]) / 2 * rs.uniform(0.6, 1.0, N_GT)
    masks = (((xx[None] - cx[:, None, None]) / rx[:, None, None]) ** 2
             + ((yy[None] - cy[:, None, None]) / ry[:, None, None]) ** 2
             ) <= 1
    return boxes, labels, masks


@pytest.fixture(scope="module")
def jax_fn(jm):
    return jax_loss_fn(jm)


@pytest.fixture(scope="module")
def data(jax_fn, variables):
    """The dataset and the two batches of the CLI's first epoch (JAX's
    loader and collate, the loader's shuffle with seed 0): each batch's
    gts made from its images' proposals in a train-mode forward at the
    initial weights (no gt valid, so only the forward matters)."""
    imgs = [np.random.RandomState(100 + i).randint(0, 256, (PX, PX, 3),
                                                   np.uint8)
            for i in range(N_IMG)]
    empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32),
             np.zeros((0, PX, PX), bool))
    gts = [empty] * N_IMG
    ds = Crafted(imgs, gts)

    def loader():
        return j_create_loader(
            ds, BS, is_training=True, num_threads=1,
            collate_fn=lambda s: j_collate(s, max_boxes=MAX_BOXES))
    rs = np.random.RandomState(7)
    for b, _ in zip(loader(), range(2)):
        (_, (_, out, _)), _ = jax_fn(variables["params"],
                                     variables["batch_stats"], dict(b))
        props = np.asarray(out["proposals"])
        for img, p in zip(b["image"], props):
            i = next(j for j in range(N_IMG) if np.array_equal(imgs[j], img))
            gts[i] = gts_from_proposals(p, rs)
    batches = [dict(b) for b, _ in zip(loader(), range(2))]
    assert sum(int(b["gt_valid"].sum()) for b in batches) == 4 * N_GT
    return {"ds": ds, "batches": batches}


def port_model(v):
    tm = M.MaskRCNN(create_model("lemevit_micro", device="cpu",
                                 features_only=True), **KW)
    tm.load_state_dict(from_jax_maskrcnn(v, tm), strict=True)
    return tm


def port_batch(b):
    return {"image": tt(b["image"]), "gt_boxes": tt(b["gt_boxes"]),
            "gt_labels": tt(b["gt_labels"]).long(),
            "gt_masks": tt(b["gt_masks"]), "gt_valid": tt(b["gt_valid"])}


def _sorted_gaps(x, k=None):
    """The smallest gap between neighbours of ``x`` sorted along its last
    dim (among its first k + 1 where k is given)."""
    s = torch.sort(x, -1, descending=True).values
    if k is not None:
        s = s[..., :k + 1]
    return (s[..., :-1] - s[..., 1:]).min()


def decision_margins(model, b):
    """The smallest distance of each discrete decision to its threshold,
    from the port's own values: the RPN's top-K order, the anchors' IoUs
    against 0.7 / 0.3, the proposals' IoUs against 0.5 and their best gt,
    the mask targets against 0.5; in eval mode also the class argmax,
    score_thr and the NMS IoUs against 0.5."""
    out = {}
    with torch.no_grad():
        pyr = model.neck(model.backbone(normalize(b["image"])))
        scores, deltas = model.rpn(pyr)
        s = torch.cat([x.reshape(len(b["image"]), -1) for x in scores], 1)
        out["rpn_topk"] = _sorted_gaps(s, model.num_proposals)
        anchors = torch.cat(M.make_anchors([f.shape[1:3] for f in pyr],
                                           model.strides))
        a_xyxy = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2,
                            anchors[:, :2] + anchors[:, 2:] / 2], -1)
        iou = box_iou(a_xyxy, b["gt_boxes"])
        out["anchor_iou"] = torch.minimum((iou - 0.7).abs(),
                                          (iou - 0.3).abs()).min()
        captured = []
        hook = model.box_head.register_forward_hook(
            lambda mod, args, o: captured.append(o[0]))
        res = model(normalize(b["image"]))
        hook.remove()
        if model.training:
            props = res["proposals"]
            iou = box_iou(props, b["gt_boxes"])
            iou = torch.where(b["gt_valid"][:, None, :], iou,
                              torch.full_like(iou, -1.0))
            out["roi_iou"] = (iou - 0.5).abs().min()
            # the best gt, where it overlaps at all (exact zeros tie
            # alike in both packages: the first gt wins)
            top2 = torch.topk(iou, 2, -1).values
            hit = top2[..., 0] > 0
            out["best_gt"] = (top2[..., 0] - top2[..., 1])[hit].min()
            g = b["gt_masks"].shape[1]
            src = (torch.arange(len(props))[:, None] * g
                   + iou.argmax(-1)).reshape(-1, 1).float()
            ms = res["masks"].shape[2]
            crops = roi_align(b["gt_masks"].reshape(-1, PX, PX, 1).float(),
                              torch.cat([src, props.reshape(-1, 4)], -1),
                              (ms, ms), aligned=True)
            # exactly 0.5 is an average of saturated taps (two of four
            # samples inside the mask), exact in both packages
            d = (crops - 0.5).abs()
            out["mask_target"] = d[d > 0].min()
        else:
            probs = torch.softmax(captured[0], -1)[:, :-1]
            out["class_argmax"] = _sorted_gaps(probs, 1)
            same = res["labels"][..., :, None] == res["labels"][..., None, :]
            same &= ~torch.eye(same.shape[-1], dtype=torch.bool)
            iou = box_iou(res["boxes"], res["boxes"])[same]
            out["det_nms"] = torch.cat([(iou - model.nms_iou).abs(),
                                        torch.ones(1)]).min()
            out["score_thr"] = (probs.max(-1).values
                                - model.score_thr).abs().min()
    return {k: float(v) for k, v in out.items()}


def test_from_jax_maskrcnn_names(variables):
    tm = port_model(variables)
    sd = tm.state_dict()
    for key in ("neck.lateral0.weight", "box_head.fc1.weight",
                "mask_head.upsample.weight", "mask_head.mask.bias",
                "backbone.downsample_layers.0.1.running_mean"):
        assert key in sd, key
    close(sd["mask_head.upsample.weight"].permute(2, 3, 1, 0),
          variables["params"]["mask_head"]["upsample"]["kernel"])


@pytest.fixture(scope="module")
def jax_eval(jm, variables, data):
    return jax.device_get(jax.jit(lambda v, x: jm.apply(v, j_normalize(x)))(
        variables, data["batches"][0]["image"]))


@pytest.fixture(scope="module")
def jax_grad(jax_fn, variables, data):
    (total, (parts, out, stats)), grads = jax_fn(
        variables["params"], variables["batch_stats"], data["batches"][0])
    return jax.device_get({"total": total, "parts": parts, "out": out,
                           "stats": stats, "grads": grads})


def port_forward(variables, data, train):
    """The port's outputs on batch 0 and its decisions' margins."""
    tm = port_model(variables).train(train)
    b = port_batch(data["batches"][0])
    margins = decision_margins(tm, b)
    tm = port_model(variables).train(train)
    with torch.no_grad():
        return tm(normalize(b["image"])), margins


@pytest.fixture(scope="module")
def port_eval(variables, data):
    return port_forward(variables, data, False)


@pytest.fixture(scope="module")
def port_train(variables, data):
    return port_forward(variables, data, True)


@pytest.mark.parametrize("key", ["boxes", "scores", "labels", "keep",
                                 "masks"])
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
                                 "proposals", "roi_cls", "roi_reg", "masks",
                                 "rois"])
def test_train_outputs(port_train, jax_grad, key):
    out, margins = port_train
    assert min(margins.values()) > MARGIN, margins
    close(out[key], jax_grad["out"][key], OUT_TOL)


def test_forward_on_given_proposals(variables, data, port_train):
    """MaskRCNN(images, proposals) runs the heads on the proposals given:
    its own proposals give its own outputs."""
    out, _ = port_train
    tm = port_model(variables).train()
    with torch.no_grad():
        again = tm(normalize(tt(data["batches"][0]["image"])),
                   out["proposals"])
    for key in ("rois", "roi_cls", "roi_reg", "masks", "rpn_scores"):
        close(again[key], out[key])


def test_loss_on_jax_outputs(jax_grad, data):
    """mask_rcnn_loss on JAX's own train outputs, against JAX's loss of
    them: every part, with positives in the RoI and mask terms."""
    b = port_batch(data["batches"][0])
    out = {k: tt(v) for k, v in jax_grad["out"].items()}
    total, parts = M.mask_rcnn_loss(out, b["gt_boxes"], b["gt_labels"],
                                    b["gt_masks"], b["gt_valid"],
                                    KW["num_classes"])
    assert tuple(parts) == PARTS
    for k in PARTS:
        close(parts[k], jax_grad["parts"][k], OUT_TOL)
    close(total, jax_grad["total"], OUT_TOL)
    assert min(float(parts[k]) for k in ("roi_reg", "mask")) > 0


@pytest.fixture(scope="module")
def port_step(variables, data):
    """The port's loss and gradients on batch 0 (train mode), and the
    RPN-only part's gradient for the proposal flow."""
    tm = port_model(variables).train()
    b = port_batch(data["batches"][0])
    out = tm(normalize(b["image"]))
    total, parts = M.mask_rcnn_loss(out, b["gt_boxes"], b["gt_labels"],
                                    b["gt_masks"], b["gt_valid"],
                                    KW["num_classes"])
    total.backward(retain_graph=True)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in tm.named_parameters()}
    tm.zero_grad()
    (parts["rpn_cls"] + parts["rpn_reg"]).backward()
    rpn_only = tm.rpn.rpn_reg.weight.grad.clone()
    return {"total": total.detach(), "parts": parts, "grads": grads,
            "rpn_only": rpn_only, "model": tm}


def test_mask_rcnn_loss(jax_grad, port_step):
    close(port_step["total"], jax_grad["total"], OUT_TOL)
    for k in PARTS:
        close(port_step["parts"][k], jax_grad["parts"][k], OUT_TOL)


@pytest.mark.parametrize("group", ["backbone", "neck", "rpn", "box_head",
                                   "mask_head"])
def test_gradients(variables, jax_grad, port_step, group):
    want = from_jax_maskrcnn({"params": jax_grad["grads"],
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
    if group == "mask_head":
        assert float(port_step["grads"]["mask_head.mask.weight"].abs().max()
                     ) > 0


def test_gradient_flows_through_the_proposals(variables, jax_grad,
                                              port_step):
    """The RPN's regressor gets gradient from the RoI losses through the
    proposals (sample coordinates, box targets), in both packages."""
    want = from_jax_maskrcnn({"params": jax_grad["grads"],
                              "batch_stats": variables["batch_stats"]},
                             port_step["model"])["rpn.rpn_reg.weight"]
    got = port_step["grads"]["rpn.rpn_reg.weight"]
    via = got - port_step["rpn_only"]
    assert float(via.abs().max()) > 1e-3 * float(got.abs().max())
    close(via, want - port_step["rpn_only"], GRAD_TOL)


def test_batch_statistics(variables, data, jax_grad):
    tm = port_model(variables).train()
    with torch.no_grad():
        tm(normalize(tt(data["batches"][0]["image"])))
    want = from_jax_maskrcnn({"params": variables["params"],
                              "batch_stats": jax_grad["stats"]}, tm)
    sd = tm.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        close(sd[k], want[k], OUT_TOL)


def test_cli_two_steps_against_jax_train_step(variables, data, jax_fn,
                                              monkeypatch, tmp_path):
    """cli.train_maskrcnn --device cpu --synthetic, 2 steps with --sched
    step (one warmup iteration), --clip-grad and --weight-decay, from the
    JAX weights and on the crafted dataset, against JAX's train step
    (optax clip_by_global_norm + adamw on mm_step_schedule) on the same
    two batches. The change from the initial weights is held to JAX's
    change in L2: over all parameters within STEP_TOL of JAX's (a no-op
    step, a flipped sign, a dropped clip or weight decay miss it by
    15-200 %), and each tensor within TENSOR_STEP_TOL of its
    own; 2 LR where the exact gradient is structurally zero; the
    BatchNorm statistics at the gradients' tolerance. The CLI's eval ran
    and kept a checkpoint."""
    sched = j_mm_step(CLI_LR, 2, warmup_iters=1)
    tx = optax.chain(optax.clip_by_global_norm(CLI_CLIP),
                     optax.adamw(sched, weight_decay=CLI_WD))
    params, stats = variables["params"], variables["batch_stats"]
    opt = tx.init(params)

    @jax.jit
    def update(g, opt, params):
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt
    for b in data["batches"]:
        (_, (_, _, stats)), g = jax_fn(params, stats, b)
        params, opt = update(g, opt, params)
    want = from_jax_maskrcnn(jax.device_get({"params": params,
                                             "batch_stats": stats}),
                             port_model(variables))

    monkeypatch.setattr(train_maskrcnn, "build_model",
                        lambda args, device=None: port_model(variables))
    monkeypatch.setattr(port_coco, "SyntheticInstanceSeg",
                        lambda n, size, nc: data["ds"])
    res = train_maskrcnn.main([
        "--synthetic", "--device", "cpu", "--backbone", "lemevit_micro",
        "--img-size", str(PX), "--batch-size", str(BS), "--epochs", "1",
        "--steps-per-epoch", "2", "--num-classes", str(KW["num_classes"]),
        "--fpn-channels", "16", "--num-proposals", "8",
        "--max-boxes", str(MAX_BOXES), "--sched", "step",
        "--warmup-iters", "1", "--lr", str(CLI_LR),
        "--weight-decay", str(CLI_WD), "--clip-grad", str(CLI_CLIP),
        "--workers", "1", "--eval-samples", "2", "--output", str(tmp_path)])
    assert res["steps"] == 2 and 0.0 <= res["best_mask_mAP"] <= 1.0
    assert set(res["metrics"]) >= {"mAP", "mask_mAP"}
    sd = torch.load(latest_checkpoint(str(tmp_path / "checkpoints")),
                    weights_only=True)["state_dict"]
    init = from_jax_maskrcnn(variables, port_model(variables))
    names = {n for n, _ in port_model(variables).named_parameters()}
    assert names <= set(want)
    num = den = 0.0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k not in names:
            close(sd[k], w, GRAD_TOL)
            continue
        got, dj = (sd[k] - init[k]).numpy(), (w - init[k]).numpy()
        live = _live_grad(k, dj)
        err = got - dj
        ref = np.linalg.norm(dj[live])
        assert ref > 0 or not live.any(), k
        assert np.linalg.norm(err[live]) <= TENSOR_STEP_TOL * ref + 1e-7, (
            k, np.linalg.norm(err[live]), ref)
        assert np.abs(err[~live]).max(initial=0) <= 2 * CLI_LR, k
        num += float(np.sum(err[live] ** 2))
        den += float(np.sum(dj[live] ** 2))
    assert np.sqrt(num) <= STEP_TOL * np.sqrt(den), (np.sqrt(num),
                                                     np.sqrt(den))
