"""Oriented object detection training and evaluation CLI: counterpart of
lemevit_tpu/cli/train_det.py, with its flags, config files
(configs/det/oriented_rcnn_*.yaml), outputs and loop, plus ``--device``
(default cuda), ``--attn-backend`` and ``--seed``.

OrientedRCNN (tasks/detection.py) over a features_only backbone with
detection_loss (tasks/detection_train.py); AdamW over every parameter
(optax.adamw with no mask: eps 1e-8, weight decay on every tensor, a
parameter that gets no gradient decays all the same), after a clip by
global norm (--clip-grad, optax.clip_by_global_norm's rule); the LR of
--sched cosine (optax.warmup_cosine_decay_schedule(0, lr, total // 20,
total)) or --sched step (the mmcv schedule of record, train/optim.py::
mm_step_schedule). The eval predicts one image at a time (B = 1), keeps
the rotated-NMS survivors, and scores VOC mAP (tasks/map_eval.py) or,
with --format-only, writes the DOTA submission (tasks/dota.py). With
--tile the data dir holds original-size DOTA: training tiles on the fly
(data/dota_split.py::TiledDOTADataset) and the eval merges the tiles'
detections back to the original images. The best checkpoint by mAP is
kept (train/checkpoint.py). bf16 autocast by default on CUDA; a LeMeViT
backbone runs through the port's kernel dispatch.

Usage:
  python -m lemevit_tpu_torch.cli.train_det \\
      --config configs/det/oriented_rcnn_lemevit_small_fpn_1x_dota10.yaml \\
      --data-dir /data/DOTA_1024
  python -m lemevit_tpu_torch.cli.train_det --synthetic --device cpu \\
      --backbone lemevit_micro --img-size 64 --batch-size 2 --epochs 1 \\
      --steps-per-epoch 2 --num-proposals 16 --rpn-nms-pre 32 \\
      --fpn-channels 32 --output /tmp/det
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lemevit_tpu_torch.attn.modules import BACKENDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch detection")
    p.add_argument("--data-dir", default="")
    p.add_argument("--backbone", default="lemevit_small")
    p.add_argument("--num-classes", type=int, default=15)
    p.add_argument("--img-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--sched", default="cosine", choices=["cosine", "step"],
                   help="'step' = the reference's mmcv schedule of record "
                        "(schedule_1x/2x/3x: epoch milestones + iteration "
                        "warmup)")
    p.add_argument("--decay-milestones", type=float, nargs="*",
                   default=[8, 11])
    p.add_argument("--decay-rate", type=float, default=0.1)
    p.add_argument("--warmup-iters", type=int, default=500)
    p.add_argument("--warmup-ratio", type=float, default=1e-3)
    p.add_argument("--clip-grad", type=float, default=None,
                   help="global-norm gradient clip (reference "
                        "optimizer_config grad_clip max_norm=35)")
    p.add_argument("--num-proposals", type=int, default=256)
    p.add_argument("--rpn-nms-pre", type=int, default=512,
                   help="per-level pre-NMS top-k in the RPN (reference "
                        "OBBDetection config: 2000)")
    p.add_argument("--max-boxes", type=int, default=64)
    p.add_argument("--fpn-channels", type=int, default=256)
    p.add_argument("--output", default="./output/det")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--initial-checkpoint", default="",
                   help="pretrained backbone weights (.pth)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps-per-epoch", type=int, default=0)
    p.add_argument("--format-only", action="store_true",
                   help="dump DOTA submission instead of computing mAP")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bf16 compute under autocast (default on CUDA)")
    p.add_argument("--tile", action="store_true",
                   help="data-dir holds ORIGINAL-size DOTA; tile on the "
                        "fly and merge detections across tiles")
    p.add_argument("--tile-size", type=int, default=1024)
    p.add_argument("--tile-gap", type=int, default=200)
    p.add_argument("--tile-iof", type=float, default=0.7)
    p.add_argument("--merge-iou", type=float, default=0.1)
    p.add_argument("--attn-backend", default="auto", choices=list(BACKENDS),
                   help="a LeMeViT backbone's block dispatch ('torch' "
                        "composes every block in plain PyTorch)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    return p


def build_model(args, device=None) -> torch.nn.Module:
    """OrientedRCNN over --backbone (features_only) from --seed, on
    ``device``."""
    from lemevit_tpu_torch.tasks.detection import create_oriented_rcnn
    bb_kw = ({"attn_backend": args.attn_backend}
             if args.backbone.startswith(("lemevit", "vit")) else {})
    return create_oriented_rcnn(
        args.backbone, device=device, seed=args.seed, backbone_kwargs=bb_kw,
        num_classes=args.num_classes, fpn_channels=args.fpn_channels,
        num_proposals=args.num_proposals, rpn_nms_pre=args.rpn_nms_pre)


def cosine_schedule(lr: float, total: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, max(total // 20, 1),
    max(total, 2)): linear warmup from 0, then cosine decay to 0."""
    warm, decay = max(total // 20, 1), max(total, 2)

    def schedule(t: int) -> float:
        if t < warm:
            return lr * t / warm
        frac = min(t - warm, decay - warm) / (decay - warm)
        return lr * 0.5 * (1 + math.cos(math.pi * frac))

    return schedule


def build_schedule(args, steps_per_epoch: int) -> Callable[[int], float]:
    if args.sched == "step":
        from lemevit_tpu_torch.train.optim import mm_step_schedule
        return mm_step_schedule(args.lr, steps_per_epoch,
                                milestones=args.decay_milestones,
                                gamma=args.decay_rate,
                                warmup_iters=args.warmup_iters,
                                warmup_ratio=args.warmup_ratio)
    return cosine_schedule(args.lr, args.epochs * steps_per_epoch)


def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    return (torch.autocast(device.type, dtype=dtype) if dtype is not None
            else contextlib.nullcontext())


def det_train_step(model, optimizer, lr: float,
                   batch: Dict[str, torch.Tensor], num_classes: int,
                   clip_grad: Optional[float] = None,
                   autocast_dtype: Optional[torch.dtype] = None):
    """One update: the train-mode forward of the normalized images (under
    autocast when given), detection_loss in fp32, backward, the
    global-norm clip (optax's: g * clip / |g| where |g| >= clip), AdamW at
    ``lr`` over every parameter (unreached ones with zero gradients).
    Returns (loss, parts), detached device tensors."""
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.tasks.detection_train import detection_loss
    model.train()
    images = batch["image"]
    with _autocast(images.device, autocast_dtype):
        out = model(normalize(images))
    loss, parts = detection_loss(out, batch["gt_obbs"], batch["gt_labels"],
                                 batch["gt_mask"], num_classes)
    apply_update(model, optimizer, lr, loss, clip_grad)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}


def apply_update(model, optimizer, lr: float, loss: torch.Tensor,
                 clip_grad: Optional[float] = None) -> None:
    """The update of the detection CLIs' steps: backward, zero gradients
    for unreached parameters, the global-norm clip (optax's: g * clip / |g|
    where |g| >= clip), the optimizer's step at ``lr``."""
    from lemevit_tpu_torch.train.steps import global_norm
    loss.backward()
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if clip_grad:
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        scale = torch.where(norm < clip_grad, torch.ones_like(norm),
                            clip_grad / norm)
        torch._foreach_mul_(grads, scale)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


@torch.no_grad()
def predict(model, image_u8: torch.Tensor,
            autocast_dtype: Optional[torch.dtype] = None
            ) -> Dict[str, np.ndarray]:
    """The eval-mode detections of one uint8 (H, W, 3) image: its kept
    rows' "boxes" (K, 5), "scores" (K,) and "labels" (K,), on the host."""
    from lemevit_tpu_torch.data.transforms import normalize
    model.eval()
    with _autocast(image_u8.device, autocast_dtype):
        out = model(normalize(image_u8[None]))
    keep = out["keep"][0]
    return {"boxes": out["boxes"][0][keep].float().cpu().numpy(),
            "scores": out["scores"][0][keep].float().cpu().numpy(),
            "labels": out["labels"][0][keep].cpu().numpy().astype(np.int32)}


def main(argv=None) -> dict:
    from lemevit_tpu_torch.utils.parser import parse_args_with_config
    args, args_text = parse_args_with_config(build_parser(), argv)
    return train(args, args_text)


def train(args, args_text: str = "") -> dict:
    from lemevit_tpu_torch.data.detection import (DOTADataset,
                                                  SyntheticDetection,
                                                  detection_collate)
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.models.registry import resolve_device
    from lemevit_tpu_torch.tasks.dota import write_dota_submission
    from lemevit_tpu_torch.tasks.map_eval import evaluate_map
    from lemevit_tpu_torch.train.checkpoint import (load_backbone,
                                                    save_checkpoint)
    from lemevit_tpu_torch.train.state import TrainState
    from lemevit_tpu_torch.utils.logging import setup_logging
    from lemevit_tpu_torch.utils.profiling import StepTimer

    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "args.yaml"), "w") as f:
        f.write(args_text)
    logger = setup_logging(os.path.join(args.output, "train.log"))
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    amp = torch.bfloat16 if bf16 else None
    logger.info("device=%s bf16=%s backbone=%s", device, bf16, args.backbone)

    if args.synthetic:
        train_ds = SyntheticDetection(4 * args.batch_size, args.img_size,
                                      args.num_classes)
        val_ds = SyntheticDetection(2 * args.batch_size, args.img_size,
                                    args.num_classes)
    elif args.tile:
        from lemevit_tpu_torch.data.dota_split import TiledDOTADataset
        train_ds = TiledDOTADataset(args.data_dir, "train",
                                    size=args.tile_size, gap=args.tile_gap,
                                    iof_thr=args.tile_iof)
        val_ds = TiledDOTADataset(args.data_dir, "val",
                                  size=args.tile_size, gap=args.tile_gap,
                                  iof_thr=args.tile_iof, keep_empty=True)
        args.img_size = args.tile_size
    else:
        train_ds = DOTADataset(args.data_dir, "train")
        val_ds = DOTADataset(args.data_dir, "val")
    train_loader = create_loader(
        train_ds, args.batch_size, is_training=True, seed=args.seed,
        num_threads=args.workers, device=device,
        collate_fn=lambda s: detection_collate(s, max_boxes=args.max_boxes))
    steps_per_epoch = args.steps_per_epoch or max(len(train_loader), 1)

    model = build_model(args, device)
    if args.initial_checkpoint:
        load_backbone(model.backbone, args.initial_checkpoint)
    sched = build_schedule(args, steps_per_epoch)
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=args.weight_decay)
    state = TrainState(model=model, optimizer=optimizer, schedule=sched)

    def evaluate() -> dict:
        dets, gts, tile_entries = {}, {}, []
        for i in range(len(val_ds)):
            img, obbs, labels = val_ds[i]
            det = predict(model, torch.from_numpy(np.array(img)).to(device),
                          amp)
            if args.tile:
                tile_entries.append((val_ds.names[i], det["boxes"],
                                     det["scores"], det["labels"]))
            else:
                dets[str(i)] = det
                gts[str(i)] = {"boxes": obbs, "labels": labels}
        if args.tile:
            # shift to original coords + cross-tile rotated NMS, then score
            # against the original images' ground truth
            from lemevit_tpu_torch.data.dota_split import \
                merge_tile_detections
            dets = merge_tile_detections(tile_entries, iou_thr=args.merge_iou)
            gts = val_ds.original_gts()
            for stem in gts:
                dets.setdefault(stem, {
                    "boxes": np.zeros((0, 5), np.float32),
                    "scores": np.zeros((0,), np.float32),
                    "labels": np.zeros((0,), np.int32)})
        model.train()
        if args.format_only:
            write_dota_submission(os.path.join(args.output, "submission"),
                                  dets)
            return {"mAP": -1.0}
        return evaluate_map(dets, gts, args.num_classes)

    timer = StepTimer(device)
    best = -1.0
    metrics: dict = {"mAP": 0.0}
    loss = torch.zeros(())
    parts: Dict[str, torch.Tensor] = {}
    for epoch in range(args.epochs):
        train_loader.set_epoch(epoch)
        it = iter(train_loader)
        for _ in range(steps_per_epoch):
            batch = next(it, None)
            if batch is None:  # more steps than batches: start over
                it = iter(train_loader)
                batch = next(it)
            timed = state.step > 0  # the steady window: steps 2..n
            if timed:
                timer.start()
            loss, parts = det_train_step(model, optimizer, sched(state.step),
                                         batch, args.num_classes,
                                         args.clip_grad, amp)
            state.step += 1
            if timed:
                timer.stop()
        it.close()
        metrics = evaluate()
        logger.info("epoch %d loss %.4f %s", epoch, float(loss),
                    json.dumps({k: round(float(v), 4)
                                for k, v in parts.items()}
                               | {"mAP": round(metrics["mAP"], 4)}))
        if metrics["mAP"] > best:
            best = metrics["mAP"]
            save_checkpoint(os.path.join(args.output, "checkpoints"), state,
                            metric=metrics["mAP"])
    steady = sum(timer.times)
    return {"best_mAP": best, "steps": state.step, "loss": float(loss),
            "parts": {k: float(v) for k, v in parts.items()},
            "final_metrics": metrics,
            "img_per_sec": (len(timer.times) * args.batch_size / steady
                            if steady else None),
            "step_ms": timer.mean_ms if timer.times else None}


if __name__ == "__main__":
    main()
