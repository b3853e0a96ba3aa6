"""Mask R-CNN instance-segmentation training and evaluation CLI:
counterpart of lemevit_tpu/cli/train_maskrcnn.py, with its flags, config
file (configs/coco/mask_rcnn_lemevit_small_fpn_1x_coco.yaml), outputs and
loop, plus ``--device`` (default cuda), ``--attn-backend``, ``--seed`` and
``--bf16/--no-bf16``.

MaskRCNN (tasks/mask_rcnn.py) over a features_only backbone with
mask_rcnn_loss; AdamW over every parameter (optax.adamw with no mask),
after the clip by global norm (--clip-grad); the LR of --sched cosine
(optax.warmup_cosine_decay_schedule(0, lr, total // 20, total)) or --sched
step (train/optim.py::mm_step_schedule), as cli/train_det.py. The eval
predicts one image at a time (B = 1), keeps the class-aware NMS
survivors, pastes their masks into the image (data/coco.py::paste_masks)
and scores box mAP@0.5 (tasks/map_eval.py::evaluate_map) and mask
mAP@[.5:.95] (evaluate_mask_map); the best checkpoint by mask mAP is
kept. bf16 autocast by default on CUDA; a LeMeViT backbone runs through
the port's kernel dispatch.

Usage:
  python -m lemevit_tpu_torch.cli.train_maskrcnn \\
      --config configs/coco/mask_rcnn_lemevit_small_fpn_1x_coco.yaml \\
      --data-dir /data/coco
  python -m lemevit_tpu_torch.cli.train_maskrcnn --synthetic --device cpu \\
      --backbone lemevit_micro --img-size 64 --batch-size 2 \\
      --num-classes 3 --epochs 1 --steps-per-epoch 2 --num-proposals 8 \\
      --max-boxes 4 --fpn-channels 16 --output /tmp/maskrcnn
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from lemevit_tpu_torch.attn.modules import BACKENDS
from lemevit_tpu_torch.cli.train_det import (_autocast, apply_update,
                                             build_schedule)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch mask r-cnn")
    p.add_argument("--data-dir", default="", help="COCO root")
    p.add_argument("--train-split", default="train2017")
    p.add_argument("--val-split", default="val2017")
    p.add_argument("--backbone", default="lemevit_small")
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--sched", default="cosine", choices=["cosine", "step"])
    p.add_argument("--decay-milestones", type=float, nargs="*",
                   default=[8, 11])
    p.add_argument("--decay-rate", type=float, default=0.1)
    p.add_argument("--warmup-iters", type=int, default=500)
    p.add_argument("--warmup-ratio", type=float, default=1e-3)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--num-proposals", type=int, default=128)
    p.add_argument("--max-boxes", type=int, default=32)
    p.add_argument("--fpn-channels", type=int, default=256)
    p.add_argument("--output", default="./output/maskrcnn")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--initial-checkpoint", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps-per-epoch", type=int, default=0)
    p.add_argument("--eval-samples", type=int, default=0,
                   help="cap val images per eval (0 = all)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bf16 compute under autocast (default on CUDA)")
    p.add_argument("--attn-backend", default="auto", choices=list(BACKENDS),
                   help="a LeMeViT backbone's block dispatch ('torch' "
                        "composes every block in plain PyTorch)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    return p


def build_model(args, device=None) -> torch.nn.Module:
    """MaskRCNN over --backbone (features_only) from --seed, on
    ``device``."""
    from lemevit_tpu_torch.tasks.mask_rcnn import create_mask_rcnn
    bb_kw = ({"attn_backend": args.attn_backend}
             if args.backbone.startswith(("lemevit", "vit")) else {})
    return create_mask_rcnn(
        args.backbone, device=device, seed=args.seed, backbone_kwargs=bb_kw,
        num_classes=args.num_classes, fpn_channels=args.fpn_channels,
        num_proposals=args.num_proposals)


def maskrcnn_train_step(model, optimizer, lr: float,
                        batch: Dict[str, torch.Tensor], num_classes: int,
                        clip_grad: Optional[float] = None,
                        autocast_dtype: Optional[torch.dtype] = None):
    """One update: the train-mode forward of the normalized images (under
    autocast when given), mask_rcnn_loss in fp32, then
    cli/train_det.apply_update. Returns (loss, parts), detached device
    tensors."""
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.tasks.mask_rcnn import mask_rcnn_loss
    model.train()
    images = batch["image"]
    with _autocast(images.device, autocast_dtype):
        out = model(normalize(images))
    loss, parts = mask_rcnn_loss(out, batch["gt_boxes"], batch["gt_labels"],
                                 batch["gt_masks"], batch["gt_valid"],
                                 num_classes)
    apply_update(model, optimizer, lr, loss, clip_grad)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}


@torch.no_grad()
def predict(model, image_u8: torch.Tensor,
            autocast_dtype: Optional[torch.dtype] = None
            ) -> Dict[str, np.ndarray]:
    """The eval-mode output of one uint8 (H, W, 3) image: its kept rows'
    "boxes" (K, 4), "scores" (K,), "labels" (K,) and "masks" (K, 2 m,
    2 m, C) probabilities, on the host."""
    from lemevit_tpu_torch.data.transforms import normalize
    model.eval()
    with _autocast(image_u8.device, autocast_dtype):
        out = model(normalize(image_u8[None]))
    keep = out["keep"][0]
    return {"boxes": out["boxes"][0][keep].float().cpu().numpy(),
            "scores": out["scores"][0][keep].float().cpu().numpy(),
            "labels": out["labels"][0][keep].cpu().numpy(),
            "masks": out["masks"][0][keep].float().cpu().numpy()}


def main(argv=None) -> dict:
    from lemevit_tpu_torch.utils.parser import parse_args_with_config
    args, args_text = parse_args_with_config(build_parser(), argv)
    return train(args, args_text)


def train(args, args_text: str = "") -> dict:
    from lemevit_tpu_torch.data.coco import (COCODataset,
                                             SyntheticInstanceSeg,
                                             instance_collate, paste_masks)
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.models.registry import resolve_device
    from lemevit_tpu_torch.tasks.map_eval import (evaluate_map,
                                                  evaluate_mask_map)
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
        train_ds = SyntheticInstanceSeg(4 * args.batch_size, args.img_size,
                                        args.num_classes)
        val_ds = SyntheticInstanceSeg(2 * args.batch_size, args.img_size,
                                      args.num_classes)
    else:
        train_ds = COCODataset(args.data_dir, args.train_split,
                               img_size=args.img_size)
        val_ds = COCODataset(args.data_dir, args.val_split,
                             img_size=args.img_size)
    train_loader = create_loader(
        train_ds, args.batch_size, is_training=True, seed=args.seed,
        num_threads=args.workers, device=device,
        collate_fn=lambda s: instance_collate(s, max_boxes=args.max_boxes))
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
        dets_box, dets_mask, gts_box, gts_mask = {}, {}, {}, {}
        n = len(val_ds)
        if args.eval_samples:
            n = min(n, args.eval_samples)
        for i in range(n):
            img, boxes, labels, masks = val_ds[i]
            out = predict(model, torch.from_numpy(np.array(img)).to(device),
                          amp)
            pasted = paste_masks(out["boxes"], out["masks"], img.shape[:2],
                                 labels=out["labels"])
            key = str(i)
            dets_box[key] = {k: out[k] for k in ("boxes", "scores",
                                                 "labels")}
            dets_mask[key] = {"masks": pasted, "scores": out["scores"],
                              "labels": out["labels"]}
            gts_box[key] = {"boxes": boxes, "labels": labels}
            gts_mask[key] = {"masks": masks, "labels": labels}
        model.train()
        m = evaluate_map(dets_box, gts_box, args.num_classes)
        mm = evaluate_mask_map(dets_mask, gts_mask, args.num_classes)
        return {"mAP": m["mAP"], **mm}

    timer = StepTimer(device)
    best = -1.0
    metrics: dict = {"mAP": 0.0, "mask_mAP": 0.0}
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
            loss, parts = maskrcnn_train_step(
                model, optimizer, sched(state.step), batch, args.num_classes,
                args.clip_grad, amp)
            state.step += 1
            if timed:
                timer.stop()
        it.close()
        metrics = evaluate()
        logger.info("epoch %d loss %.4f %s", epoch, float(loss),
                    json.dumps({k: round(float(v), 4)
                                for k, v in {**parts, **metrics}.items()}))
        if metrics["mask_mAP"] > best:
            best = metrics["mask_mAP"]
            save_checkpoint(os.path.join(args.output, "checkpoints"), state,
                            metric=metrics["mask_mAP"])
    steady = sum(timer.times)
    return {"best_mask_mAP": best, "metrics": metrics, "steps": state.step,
            "loss": float(loss),
            "parts": {k: float(v) for k, v in parts.items()},
            "img_per_sec": (len(timer.times) * args.batch_size / steady
                            if steady else None),
            "step_ms": timer.mean_ms if timer.times else None}


if __name__ == "__main__":
    main()
