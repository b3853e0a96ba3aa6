"""Training CLI: the flags, outputs and loop of lemevit_tpu/cli/train.py.

  - two-stage YAML + argparse config (utils/parser.py), args.yaml record
  - data: an image folder, a zip (zipfolder) or a remote-sensing manifest
    (ucm, aid, nwpu, millionaid) through the PIL train transform (random
    resized crop, hflip, RandAugment / AugMix from --aa) and the threaded
    loader (--workers threads, or --worker-procs spawned processes); the
    eval split through the centre crop at --crop-pct; or --synthetic
  - float32 parameters, optimizer state and EMA; bf16 compute by default on
    CUDA (autocast); the C, D/D2 and S blocks train through the
    hand-written training kernels (attn/fused_train.py)
  - ``--summary`` logs the parameter table and GMACs per image
  - AdamW + warmup-cosine with the LR scaled to the global batch
  - random erasing, mixup / cutmix and label smoothing on the device
  - EMA of the parameters, per-stage remat (--remat-stages), checkpoints
    kept top-k by eval metric, mid-epoch recovery, auto-resume, summary.csv
    with a fixed field set, events.jsonl

Not ported yet, and raise: packed caches (--packed-data) and native decode
(--native-decode; ROADMAP queue 1, item 4), aug-splits / JSD (--aug-splits,
item 2), the plateau schedule and the other optimizers (item 2), and
multi-device runs (item 6).

Usage:
  python -m lemevit_tpu_torch.cli.train --config configs/lemevit.yaml \\
      --model lemevit_tiny --data-dir /data/imagenet
  python -m lemevit_tpu_torch.cli.train --synthetic --model lemevit_tiny \\
      --config configs/lemevit.yaml --epochs 1 --steps-per-epoch 6
  python -m lemevit_tpu_torch.cli.train --synthetic --model lemevit_micro \\
      --img-size 32 --batch-size 4 --device cpu --summary
  python -m lemevit_tpu_torch.cli.train --synthetic --model lemevit_tiny \\
      --train-cpe-in-kernel   # the 3x3 CPEs inside the training kernels
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import time

import numpy as np
import torch

from lemevit_tpu_torch.attn.modules import BACKENDS

SUMMARY_FIELDS = ["epoch", "train_loss", "epoch_time_s",
                  "top1", "top5", "ema_top1", "ema_top5"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch training")
    # data
    p.add_argument("--data-dir", default="")
    p.add_argument("--dataset", default="imagefolder")
    p.add_argument("--train-split", default="train")
    p.add_argument("--val-split", default="validation")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--crop-pct", type=float, default=0.9)
    p.add_argument("--workers", type=int, default=4,
                   help="loader threads")
    p.add_argument("--worker-procs", type=int, default=0,
                   help="build batches in N spawned worker processes "
                        "instead of threads")
    p.add_argument("--native-decode", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="C++ decode plane: not ported (item 4); raises "
                        "when on")
    p.add_argument("--packed-data", default="",
                   help="packed uint8 cache dir: not ported (item 4)")
    p.add_argument("--synthetic", action="store_true")
    # model
    p.add_argument("--model", default="lemevit_tiny")
    p.add_argument("--attn-backend", default="auto", choices=list(BACKENDS),
                   help="block dispatch: 'torch' composes every block in "
                        "plain PyTorch instead of the CUDA kernels")
    p.add_argument("--train-cpe-in-kernel", action="store_true",
                   help="the training kernels apply each block's 3x3 CPE "
                        "to pre-CPE tokens (the JAX PB_TRAIN_CPE=fused; "
                        "off by default)")
    p.add_argument("--drop-path", type=float, default=0.15)
    p.add_argument("--remat-stages", type=int, nargs="*", default=[])
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bf16 compute under autocast (default on CUDA)")
    p.add_argument("--initial-checkpoint", default="")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    # optimization
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--opt", default="adamw", choices=["adamw"])
    p.add_argument("--sched", default="cosine",
                   choices=["cosine", "step", "multistep", "poly",
                            "constant"])
    p.add_argument("--decay-epochs", type=float, default=90)
    p.add_argument("--decay-rate", type=float, default=0.1)
    p.add_argument("--decay-milestones", type=float, nargs="*", default=[])
    p.add_argument("--sched-power", type=float, default=1.0)
    p.add_argument("--lr-base", type=float, default=5e-4)
    p.add_argument("--lr-base-size", type=int, default=512)
    p.add_argument("--lr-base-scale", default="linear",
                   choices=["linear", "sqrt", "none"])
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=280)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--aa", default="rand-m9-mstd0.5-inc1")
    p.add_argument("--hflip", type=float, default=0.5)
    p.add_argument("--scale", type=float, nargs=2, default=[0.08, 1.0],
                   help="RandomResizedCrop scale range (timm --scale)")
    p.add_argument("--aug-splits", type=int, default=0,
                   help="AugMix splits with per-split BN: not ported "
                        "(item 2); raises above 1")
    p.add_argument("--model-ema", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--model-ema-decay", type=float, default=0.996)
    # infra
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", default="./output")
    p.add_argument("--experiment", default="")
    p.add_argument("--checkpoint-hist", type=int, default=3)
    p.add_argument("--recovery-interval", type=int, default=0,
                   help="save a rolling mid-epoch recovery checkpoint "
                        "every N steps (0 = off)")
    p.add_argument("--resume", default="")
    p.add_argument("--no-auto-resume", action="store_true")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--eval-interval", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="override (mainly for synthetic smoke runs)")
    p.add_argument("--summary", action="store_true",
                   help="log the parameter table and GMACs per image")
    return p


def main(argv=None):
    from lemevit_tpu_torch.utils.parser import parse_args_with_config

    args, args_text = parse_args_with_config(build_parser(), argv)
    return train(args, args_text)


def step_generators(seed: int, step: int, gen: torch.Generator
                    ) -> np.random.Generator:
    """Reseed ``gen`` (erasing boxes and noise, DropPath masks) and return
    a numpy Generator (mixup) for train step ``step``: the draws depend on
    (seed, step) alone, so a resumed run draws what the first would have."""
    ss = np.random.SeedSequence([seed, step])
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return np.random.default_rng(ss)


def train(args, args_text: str = "") -> dict:
    from lemevit_tpu_torch.data.datasets import create_dataset
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.data.spawn import spec_for_split
    from lemevit_tpu_torch.data.mixup import (draw_erasing, draw_mixup,
                                              mixup_cutmix, random_erasing)
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    from lemevit_tpu_torch.train.checkpoint import (auto_resume,
                                                    load_pretrained,
                                                    restore_checkpoint,
                                                    save_checkpoint,
                                                    save_recovery)
    from lemevit_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from lemevit_tpu_torch.train.state import ModelEma, TrainState
    from lemevit_tpu_torch.train.steps import eval_metrics, train_step
    from lemevit_tpu_torch.utils.events import EventWriter
    from lemevit_tpu_torch.utils.logging import setup_logging
    from lemevit_tpu_torch.utils.meters import MetricTracker

    if args.packed_data:
        raise NotImplementedError("--packed-data is not ported yet (ROADMAP "
                                  "queue 1, item 4)")
    if args.native_decode:
        raise NotImplementedError("--native-decode is not ported yet "
                                  "(ROADMAP queue 1, item 4)")
    if args.aug_splits > 1:
        raise NotImplementedError("--aug-splits is not ported yet (ROADMAP "
                                  "queue 1, item 2)")
    device = resolve_device(args.device)
    out_dir = os.path.join(args.output, args.experiment or args.model)
    os.makedirs(out_dir, exist_ok=True)
    logger = setup_logging(os.path.join(out_dir, "train.log"))
    if args_text:
        with open(os.path.join(out_dir, "args.yaml"), "w") as f:
            f.write(args_text)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    amp = torch.bfloat16 if bf16 else None
    global_batch = args.batch_size * args.grad_accum_steps
    logger.info("device=%s bf16=%s global_batch=%d", device, bf16,
                global_batch)

    # ---------------- data
    train_spec = val_spec = None
    if args.synthetic:
        train_ds = create_dataset("synthetic", num_samples=global_batch * 8,
                                  image_size=args.img_size,
                                  num_classes=args.num_classes)
        val_ds = create_dataset("synthetic", num_samples=global_batch * 2,
                                image_size=args.img_size,
                                num_classes=args.num_classes)
    else:
        if not os.path.isdir(args.data_dir):
            raise FileNotFoundError(
                f"--data-dir {args.data_dir!r} is not a directory (pass "
                "--synthetic for synthetic data)")
        # the spec builds the dataset here and in spawned workers alike
        train_spec = spec_for_split(args, args.train_split, train=True)
        val_spec = spec_for_split(args, args.val_split, train=False)
        train_ds, val_ds = train_spec.build(), val_spec.build()
        logger.info("data: %s %s, %d train / %d val samples", args.dataset,
                    args.data_dir, len(train_ds), len(val_ds))
    procs = args.worker_procs if train_spec is not None else 0
    train_loader = create_loader(
        train_ds, args.batch_size, is_training=True, seed=args.seed,
        num_threads=args.workers, num_procs=procs, dataset_spec=train_spec,
        device=device)
    val_loader = create_loader(
        val_ds, args.batch_size, num_threads=args.workers, num_procs=procs,
        dataset_spec=val_spec, device=device)
    steps_per_epoch = args.steps_per_epoch or max(len(train_loader), 1)

    # ---------------- model / optimizer / state
    model = create_model(args.model, num_classes=args.num_classes,
                         drop_path_rate=args.drop_path,
                         remat_stages=tuple(args.remat_stages),
                         attn_backend=args.attn_backend,
                         train_cpe_in_kernel=args.train_cpe_in_kernel,
                         device=device, seed=args.seed)
    if args.summary:
        from lemevit_tpu_torch.utils.profiling import (cost_analysis,
                                                       model_summary)
        logger.info("\n%s", model_summary(model))
        logger.info("GMACs/image: %.4g",
                    cost_analysis(model, args.img_size)["gmacs"])
    if args.initial_checkpoint:
        load_pretrained(model, args.initial_checkpoint)
    sched = build_lr_schedule(
        base_lr=args.lr_base, global_batch_size=global_batch,
        steps_per_epoch=steps_per_epoch,
        epochs=args.epochs, warmup_epochs=args.warmup_epochs,
        warmup_lr=args.warmup_lr, min_lr=args.min_lr,
        scaling=args.lr_base_scale, sched=args.sched,
        decay_epochs=args.decay_epochs, decay_rate=args.decay_rate,
        decay_milestones=tuple(args.decay_milestones),
        power=args.sched_power)
    state = TrainState(
        model=model, optimizer=build_optimizer(
            model, weight_decay=args.weight_decay, opt=args.opt),
        schedule=sched,
        ema=ModelEma(model, args.model_ema_decay) if args.model_ema else None,
        grad_accum_steps=args.grad_accum_steps, clip_grad=args.clip_grad)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if args.resume:
        restore_checkpoint(args.resume, state)
    elif not args.no_auto_resume:
        state, resumed = auto_resume(ckpt_dir, state)
        if resumed:
            logger.info("auto-resumed at step %d", state.step)
    gen = torch.Generator(device=device)
    model.set_generator(gen)

    def full_train_step(batch):
        rng = step_generators(args.seed, state.step, gen)
        images = normalize(batch["image"])
        labels = batch["label"]
        b, h, w, _ = images.shape
        if args.reprob > 0:
            draw = draw_erasing(gen, b, h, w, prob=args.reprob)
            noise = torch.randn(images.shape, generator=gen, device=device)
            images = random_erasing(images, draw, noise)
        if args.mixup > 0 or args.cutmix > 0:
            images, targets = mixup_cutmix(
                images, labels, args.num_classes,
                draw_mixup(rng, h, w, mixup_alpha=args.mixup,
                           cutmix_alpha=args.cutmix, prob=args.mixup_prob),
                label_smoothing=args.smoothing)
        else:
            targets = torch.nn.functional.one_hot(
                labels, args.num_classes).float()
            if args.smoothing:
                targets = (targets * (1 - args.smoothing)
                           + args.smoothing / args.num_classes)
        return train_step(state, images, targets, autocast_dtype=amp)

    def evaluate(forward) -> dict:
        sums = {"top1_sum": 0, "top5_sum": 0, "count": 0}
        for batch in val_loader:
            if batch["image"].shape[0] != args.batch_size:
                continue  # the ragged tail, as the JAX package skips it
            with autocast():
                logits = forward(normalize(batch["image"]))
            m = eval_metrics(logits, batch["label"])
            for k in sums:  # device-side sums; read once at the end
                sums[k] = sums[k] + m[k]
        tot = {k: float(v) for k, v in sums.items()}
        if not tot["count"]:
            return {}
        return {"top1": 100 * tot["top1_sum"] / tot["count"],
                "top5": 100 * tot["top5_sum"] / tot["count"]}

    def autocast():
        return (torch.autocast(device.type, dtype=amp) if amp is not None
                else contextlib.nullcontext())

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    events = EventWriter(out_dir)
    summary_path = os.path.join(out_dir, "summary.csv")
    best_top1 = -1.0
    result = {}
    start_epoch = state.step // steps_per_epoch
    # mid-epoch (recovery) resume: skip the steps this epoch already ran
    resume_skip = state.step % steps_per_epoch
    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        tracker = MetricTracker()
        t_ep = time.perf_counter()
        first = resume_skip if epoch == start_epoch else 0
        it = train_loader.iter_batches(first)
        t_warm = None
        for step_i in range(first, steps_per_epoch):
            batch = next(it, None)
            if batch is None:  # more steps than batches: start over
                it.close()
                it = iter(train_loader)
                batch = next(it)
            metrics = full_train_step(batch)
            if step_i == first:  # the steady window starts after step 1
                sync()
                t_warm = time.perf_counter()
            if (args.recovery_interval
                    and (step_i + 1) % args.recovery_interval == 0):
                save_recovery(ckpt_dir, state)
            if step_i % args.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = state.schedule(state.updates)
                tracker.update(m)
                events.log(state.step, m)
                logger.info(
                    "epoch %d step %d/%d loss %.4f gnorm %.2f lr %.2e",
                    epoch, step_i, steps_per_epoch, m["loss"],
                    m["grad_norm"], m["lr"])
        it.close()
        sync()
        t_end = time.perf_counter()
        epoch_time = t_end - t_ep
        steady = steps_per_epoch - first - 1
        if steady > 0:
            result["step_ms"] = 1e3 * (t_end - t_warm) / steady
            result["samples_per_sec"] = (steady * args.batch_size
                                         / (t_end - t_warm))

        eval_stats = {}
        if (epoch + 1) % args.eval_interval == 0:
            model.eval()
            with torch.inference_mode():
                forwards = [("", model)]
                if state.ema is not None:
                    forwards.append(
                        ("ema_", lambda x: state.ema(model, x)))
                for tag, forward in forwards:
                    for k, v in evaluate(forward).items():
                        eval_stats[tag + k] = v
            model.train()
            logger.info("epoch %d eval %s", epoch, json.dumps(
                {k: round(v, 3) for k, v in eval_stats.items()}))

        metric = max(eval_stats.get("top1", -1.0),
                     eval_stats.get("ema_top1", -1.0))
        save_checkpoint(ckpt_dir, state, metric=metric,
                        max_history=args.checkpoint_hist)
        best_top1 = max(best_top1, metric)
        result["train_loss"] = tracker.summary().get("loss", float("nan"))
        row = {"epoch": epoch, "train_loss": result["train_loss"],
               "epoch_time_s": round(epoch_time, 1),
               **{k: round(v, 4) for k, v in eval_stats.items()}}
        write_header = not os.path.exists(summary_path)
        with open(summary_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=SUMMARY_FIELDS, restval="",
                               extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)

    logger.info("done; best top1 %.3f", best_top1)
    return {"best_top1": best_top1, "steps": state.step, **result}


if __name__ == "__main__":
    main()
