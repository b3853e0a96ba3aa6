"""Semantic-segmentation training and evaluation CLI (UperNet on LeMeViT):
counterpart of lemevit_tpu/cli/train_seg.py, with its flags and defaults
and ``--device`` (default cuda) and ``--seed``.

Reference contract (mmseg's upernet_lemevit configs): UPerHead + auxiliary
FCNHead (loss weight 0.4) on the stage-3 feature, AdamW with weight decay
on every parameter, mmcv's poly LR with linear warmup, crop + flip +
photometric training pipeline, slide inference (512^2 crops, stride 384),
metrics mIoU / OA / mF1. Data layout: {root}/{split}/images/*.png and
{root}/{split}/labels/*.png (int masks); PIL is imported only for them.
bf16 autocast by default on CUDA. Blocks above the kernels' token counts
(stages 0-2 at 512^2) compose, their attention on the attention-only
kernels (attn/dca.py); stages 3-4 run the S block kernels.

Usage:
  python -m lemevit_tpu_torch.cli.train_seg --synthetic --iters 6 \\
      --eval-interval 6
  python -m lemevit_tpu_torch.cli.train_seg --synthetic --iters 6 \\
      --eval-interval 6 --train-cpe-in-kernel   # the CPEs in the kernels
  python -m lemevit_tpu_torch.cli.train_seg --synthetic --device cpu \\
      --backbone lemevit_micro --crop-size 32 --batch-size 2 --channels 16 \\
      --iters 2
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from lemevit_tpu_torch.train.checkpoint import load_backbone as _load_backbone


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch segmentation")
    p.add_argument("--data-dir", default="")
    p.add_argument("--backbone", default="lemevit_tiny")
    p.add_argument("--num-classes", type=int, default=6)  # Potsdam
    p.add_argument("--crop-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--iters", type=int, default=80000)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--min-lr", type=float, default=0.0)
    p.add_argument("--warmup-iters", type=int, default=1500)
    p.add_argument("--warmup-ratio", type=float, default=1e-6)
    p.add_argument("--ignore-index", type=int, default=None,
                   help="label value excluded from loss and metrics "
                        "(reference Potsdam recipe: num_classes 5, "
                        "ignore_index 5, mmseg avg_non_ignore CE)")
    p.add_argument("--aux-weight", type=float, default=0.4)
    p.add_argument("--channels", type=int, default=512)
    p.add_argument("--eval-interval", type=int, default=8000)
    p.add_argument("--eval-stride", type=int, default=384)
    p.add_argument("--output", default="./output/seg")
    p.add_argument("--workers", type=int, default=2,
                   help="kept for the JAX package's flag; the port's "
                        "loader builds batches in one thread")
    p.add_argument("--initial-checkpoint", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--train-cpe-in-kernel", action="store_true",
                   help="the backbone's training kernels apply the 3x3 "
                        "CPEs (the JAX PB_TRAIN_CPE=fused)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bf16 compute under autocast (default on CUDA)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    return p


class SegDataset:
    """{split}/images/*.png + {split}/labels/*.png paired dataset; training
    samples get a scale jitter (0.5-2.0) random crop, a flip and
    photometric jitter from Python's ``random`` (seeded by --seed)."""

    def __init__(self, root, split, crop, num_classes, train=True,
                 ignore_index=None):
        from PIL import Image  # noqa: F401  (fail here, not in the loader)
        self.img_dir = os.path.join(root, split, "images")
        self.lbl_dir = os.path.join(root, split, "labels")
        self.names = sorted(os.listdir(self.img_dir))
        self.crop = crop
        self.train = train
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        from PIL import Image, ImageEnhance
        img = Image.open(os.path.join(self.img_dir, self.names[i]))
        img = img.convert("RGB")
        lbl = Image.open(os.path.join(self.lbl_dir, self.names[i]))
        if self.train:
            scale = random.uniform(0.5, 2.0)
            w, h = img.size
            nw, nh = max(int(w * scale), self.crop), max(int(h * scale),
                                                         self.crop)
            img = img.resize((nw, nh), Image.BILINEAR)
            lbl = lbl.resize((nw, nh), Image.NEAREST)
            x0 = random.randint(0, nw - self.crop)
            y0 = random.randint(0, nh - self.crop)
            box = (x0, y0, x0 + self.crop, y0 + self.crop)
            img, lbl = img.crop(box), lbl.crop(box)
            if random.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                lbl = lbl.transpose(Image.FLIP_LEFT_RIGHT)
            for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                        ImageEnhance.Color):
                if random.random() < 0.5:
                    img = enh(img).enhance(random.uniform(0.7, 1.3))
        arr = np.asarray(img, np.uint8)
        mask = np.asarray(lbl, np.int32)
        if mask.ndim == 3:
            mask = mask[..., 0].astype(np.int32)
        if self.ignore_index is not None:
            # out-of-range labels fold into the ignored bucket
            mask = np.where((mask >= 0) & (mask < self.num_classes),
                            mask, self.ignore_index)
            return arr, mask
        return arr, np.clip(mask, 0, self.num_classes - 1)


class _SyntheticSeg:
    """Random uint8 images and masks, one RandomState per index (the JAX
    package's samples)."""

    def __init__(self, n, size, num_classes):
        self.n, self.size, self.nc = n, size, num_classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        img = rng.randint(0, 256, (self.size, self.size, 3), np.uint8)
        mask = rng.randint(0, self.nc, (self.size, self.size)).astype(
            np.int32)
        return img, mask


def _collate(samples) -> Dict[str, torch.Tensor]:
    """{"image": uint8 (B, H, W, 3), "mask": int64 (B, H, W)}."""
    imgs, masks = zip(*samples)
    return {"image": torch.from_numpy(np.stack(imgs)),
            "mask": torch.from_numpy(np.stack(masks).astype(np.int64))}


def seg_metrics(conf: np.ndarray) -> dict:
    """mIoU / OA / mF1 from a confusion matrix (rows=gt, cols=pred)."""
    tp = np.diag(conf).astype(np.float64)
    gt = conf.sum(1).astype(np.float64)
    pd = conf.sum(0).astype(np.float64)
    iou = tp / np.maximum(gt + pd - tp, 1e-9)
    f1 = 2 * tp / np.maximum(gt + pd, 1e-9)
    return {"mIoU": float(iou.mean() * 100),
            "OA": float(tp.sum() / max(conf.sum(), 1e-9) * 100),
            "mF1": float(f1.mean() * 100)}


def seg_loss(logits: torch.Tensor, mask: torch.Tensor,
             ignore_index: Optional[int] = None) -> torch.Tensor:
    """Per-pixel cross-entropy of NHWC logits (log-softmax in fp32), the
    mean over all pixels, or over the pixels not labelled
    ``ignore_index``."""
    pix = F.cross_entropy(logits.permute(0, 3, 1, 2).float(), mask,
                          reduction="none",
                          ignore_index=-100 if ignore_index is None
                          else ignore_index)
    if ignore_index is None:
        return pix.mean()
    valid = (mask != ignore_index).float()
    return pix.sum() / valid.sum().clamp(min=1.0)


def seg_train_step(model, optimizer, lr: float, images: torch.Tensor,
                   masks: torch.Tensor, *, aux_weight: float = 0.4,
                   ignore_index: Optional[int] = None,
                   autocast_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """One update: the train-mode forward of normalised ``images`` (under
    autocast to ``autocast_dtype`` when given), CE + aux_weight aux CE,
    backward, AdamW at ``lr``. Returns the loss as a device tensor."""
    from lemevit_tpu_torch.data.transforms import normalize
    model.train()
    ctx = (torch.autocast(images.device.type, dtype=autocast_dtype)
           if autocast_dtype is not None else contextlib.nullcontext())
    with ctx:
        logits, aux = model(normalize(images), with_aux=True)
    loss = (seg_loss(logits, masks, ignore_index)
            + aux_weight * seg_loss(aux, masks, ignore_index))
    loss.backward()
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def main(argv=None) -> dict:
    from lemevit_tpu_torch.utils.parser import parse_args_with_config
    args, args_text = parse_args_with_config(build_parser(), argv)
    return train(args, args_text)


def train(args, args_text: str = "") -> dict:
    from lemevit_tpu_torch.data.loader import Loader
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.models.registry import resolve_device
    from lemevit_tpu_torch.tasks.upernet import create_upernet, slide_inference
    from lemevit_tpu_torch.train.checkpoint import save_checkpoint
    from lemevit_tpu_torch.train.optim import warmup_poly_schedule
    from lemevit_tpu_torch.train.state import TrainState
    from lemevit_tpu_torch.utils.logging import setup_logging
    from lemevit_tpu_torch.utils.profiling import StepTimer

    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "args.yaml"), "w") as f:
        f.write(args_text)
    logger = setup_logging(os.path.join(args.output, "train.log"))
    random.seed(args.seed)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    amp = torch.bfloat16 if bf16 else None
    logger.info("device=%s bf16=%s", device, bf16)

    if args.synthetic:
        train_ds = _SyntheticSeg(4 * args.batch_size, args.crop_size,
                                 args.num_classes)
        val_ds = _SyntheticSeg(args.batch_size, args.crop_size,
                               args.num_classes)
    else:
        train_ds = SegDataset(args.data_dir, "train", args.crop_size,
                              args.num_classes, train=True,
                              ignore_index=args.ignore_index)
        val_ds = SegDataset(args.data_dir, "val", args.crop_size,
                            args.num_classes, train=False,
                            ignore_index=args.ignore_index)
    # one thread: SegDataset draws its augmentation from the module random
    loader = Loader(train_ds, args.batch_size, seed=args.seed, num_threads=1,
                    collate_fn=_collate, device=device)

    model = create_upernet(args.backbone, args.num_classes,
                           channels=args.channels, device=device,
                           seed=args.seed,
                           train_cpe_in_kernel=args.train_cpe_in_kernel)
    if args.initial_checkpoint:
        _load_backbone(model.backbone, args.initial_checkpoint)
    sched = warmup_poly_schedule(args.lr, args.iters, power=1.0,
                                 min_lr=args.min_lr,
                                 warmup_iters=args.warmup_iters,
                                 warmup_ratio=args.warmup_ratio)
    # optax.adamw as the JAX CLI builds it: decay on every parameter
    optimizer = torch.optim.AdamW(model.parameters(), lr=0.0,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=args.weight_decay)
    state = TrainState(model=model, optimizer=optimizer, schedule=sched)

    def autocast():
        return (torch.autocast(device.type, dtype=amp) if amp is not None
                else contextlib.nullcontext())

    def evaluate() -> dict:
        nc = args.num_classes
        conf = np.zeros((nc, nc), np.int64)
        model.eval()
        with torch.inference_mode():
            for i in range(len(val_ds)):
                img, mask = val_ds[i]
                x = normalize(torch.from_numpy(img)[None].to(device))

                def crop_logits(crop):
                    with autocast():
                        return model(crop)
                pred = slide_inference(crop_logits, x, nc,
                                       crop_size=args.crop_size,
                                       stride=args.eval_stride).argmax(-1)
                m, p = mask.reshape(-1), pred[0].cpu().numpy().reshape(-1)
                if args.ignore_index is not None:
                    keep = m != args.ignore_index
                    m, p = m[keep], p[keep]
                conf += np.bincount(m * nc + p, minlength=nc * nc).reshape(
                    nc, nc)
        model.train()
        return seg_metrics(conf)

    timer = StepTimer(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    epoch = 0
    it = iter(loader)
    metrics: dict = {}
    for step_i in range(args.iters):
        if step_i > 0:  # the steady window: steps 2..n, batch fetch included
            timer.start()
        batch = next(it, None)
        if batch is None:  # the loader's epoch is over: start the next
            epoch += 1
            loader.set_epoch(epoch)
            it = iter(loader)
            batch = next(it)
        loss = seg_train_step(
            model, optimizer, sched(state.step), batch["image"],
            batch["mask"], aux_weight=args.aux_weight,
            ignore_index=args.ignore_index, autocast_dtype=amp)
        state.step += 1
        if step_i > 0:
            timer.stop()
        if step_i % 50 == 0:
            logger.info("iter %d loss %.4f", step_i, float(loss))
        if (step_i + 1) % args.eval_interval == 0 or step_i == args.iters - 1:
            metrics = evaluate()
            logger.info("iter %d eval %s", step_i, json.dumps(
                {k: round(v, 2) for k, v in metrics.items()}))
            save_checkpoint(os.path.join(args.output, "checkpoints"), state,
                            metric=metrics["mIoU"])
    it.close()
    steady = sum(timer.times)
    return {
        "final_metrics": metrics, "steps": state.step,
        "loss": float(loss),
        "samples_per_sec": (len(timer.times) * args.batch_size / steady
                            if steady else None),
        "step_ms": timer.mean_ms if timer.times else None,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if device.type == "cuda" else None)}


if __name__ == "__main__":
    main()
