"""Training CLI: the flags, outputs and loop of lemevit_tpu/cli/train.py.

  - two-stage YAML + argparse config (utils/parser.py), args.yaml record
  - data: an image folder, a zip (zipfolder), a remote-sensing manifest
    (ucm, aid, nwpu, millionaid) or hub and shard data (hfds/, tfds/, wds)
    through the PIL train transform (random resized crop, hflip,
    RandAugment / AugMix from --aa) and the threaded loader (--workers
    threads, or --worker-procs spawned processes); the eval split through
    the centre crop at --crop-pct. --native-decode decodes, crops and flips
    JPEG / PNG in C++ with the GIL released (data/native_decode.py); it is
    on by default where its library builds, without --aug-splits.
    --packed-data <dir> streams a packed uint8 cache (cli/pack.py) and
    runs the random resized crop, flip and RandAugment on the device
    (data/device_aug.py), the eval on its centre crop. Or --synthetic
  - float32 parameters, optimizer state and EMA; bf16 compute by default on
    CUDA (autocast); the C, D/D2 and S blocks train through the
    hand-written training kernels (attn/fused_train.py)
  - ``--summary`` logs the parameter table and GMACs per image
  - every --opt of the JAX package (adamw by default; adam, sgd, momentum,
    nesterov, rmsprop, rmsproptf, lamb, adagrad) and every --sched
    (warmup-cosine by default; step, multistep, poly, constant, and
    plateau, whose scale PlateauController decays from the eval metric),
    the LR scaled to the global batch
  - random erasing, mixup / cutmix and label smoothing on the device
  - AugMix splits (--aug-splits S, --aa augmix-m3-w3): split 0 clean, the
    rest through AugMix, every BatchNorm with S sets of statistics, the
    JSD loss (--jsd-alpha); mixup and cutmix off; eval on the clean
    split's statistics
  - EMA of the parameters, per-stage remat (--remat-stages), checkpoints
    kept top-k by eval metric, mid-epoch recovery, auto-resume, summary.csv
    with a fixed field set, events.jsonl
  - multi-process data-parallel runs (parallel/): started torchrun-style
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK; or SLURM's
    variables), one process per card, over NCCL on CUDA (gloo on the CPU).
    --batch-size is per process; the global batch is batch x world x
    --grad-accum-steps and the LR is scaled to it. The model is built from
    the same seed on every rank and wrapped in DDP (``no_sync`` on the
    accumulation micro-steps); its BatchNorms take the global batch's
    statistics (SyncBN). Erasing, mixup / cutmix and DropPath draw over
    the global batch as the JAX package's step does
    (train/steps.py::augmented_train_step): the per-row draws at the
    global shape, the erasing noise for this rank's rows only (from a
    seed a global row), mixup's partner rows from the mirror rank by one
    send / recv. The logged loss and grad norm are the global ones; each
    rank evaluates its stride of the val split and the sums are
    all-reduced. Only rank 0 writes the log file, events,
    summary.csv, args.yaml, checkpoints and recovery files; checkpoints
    hold the inner module's state_dict (no "module." prefix), so they
    restore in any number of processes. --mesh-model-axis above 1 (tensor
    parallelism) is refused (ROADMAP queue 1, item 13).

Usage:
  python -m lemevit_tpu_torch.cli.train --config configs/lemevit.yaml \\
      --model lemevit_tiny --data-dir /data/imagenet
  python -m lemevit_tpu_torch.cli.train --synthetic --model lemevit_tiny \\
      --config configs/lemevit.yaml --epochs 1 --steps-per-epoch 6
  python -m lemevit_tpu_torch.cli.train --synthetic --model lemevit_micro \\
      --img-size 32 --batch-size 4 --device cpu --summary
  python -m lemevit_tpu_torch.cli.train --synthetic --model lemevit_tiny \\
      --train-cpe-in-kernel   # the 3x3 CPEs inside the training kernels
  python -m lemevit_tpu_torch.cli.train --synthetic --model lemevit_tiny \
      --config configs/lemevit.yaml --aug-splits 3 --jsd-loss \
      --aa augmix-m3-w3   # the AugMix / JSD recipe
  python -m lemevit_tpu_torch.cli.train --packed-data /data/packed \\
      --config configs/lemevit.yaml   # after cli.pack; aug on the device
  torchrun --nproc-per-node 4 -m lemevit_tpu_torch.cli.train \\
      --config configs/lemevit.yaml --data-dir /data/imagenet  # 4 cards
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
from lemevit_tpu_torch.train.optim import OPTIMIZERS

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
                   help="C++ decode + crop plane; default on when its "
                        "library builds (and without --aug-splits); an "
                        "explicit --native-decode raises when it does not")
    p.add_argument("--packed-data", default="",
                   help="packed uint8 cache dir (cli.pack): crop, flip and "
                        "RandAugment run on the device")
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
    p.add_argument("--opt", default="adamw", choices=list(OPTIMIZERS))
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--sched", default="cosine",
                   choices=["cosine", "step", "multistep", "poly",
                            "constant", "plateau"])
    p.add_argument("--decay-epochs", type=float, default=90)
    p.add_argument("--decay-rate", type=float, default=0.1)
    p.add_argument("--decay-milestones", type=float, nargs="*", default=[])
    p.add_argument("--sched-power", type=float, default=1.0)
    p.add_argument("--patience-epochs", type=int, default=10,
                   help="plateau schedule: epochs without eval-metric "
                        "improvement before the LR decays by --decay-rate")
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
                   help=">1 enables aug splits: split 0 clean, the rest "
                        "augmented, with per-split BN statistics and the "
                        "JSD loss")
    p.add_argument("--jsd-loss", action="store_true",
                   help="JSD consistency loss across aug splits (the loss "
                        "of every --aug-splits run, as in the JAX package)")
    p.add_argument("--jsd-alpha", type=float, default=12.0)
    p.add_argument("--model-ema", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--model-ema-decay", type=float, default=0.996)
    # infra
    p.add_argument("--mesh-model-axis", type=int, default=1,
                   help="tensor-parallel ranks per model replica; only 1 "
                        "is ported (ROADMAP queue 1, item 13)")
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


class SplitViews:
    """Synthetic-data stand-in for build_augsplit_transform: each sample
    repeated into (S, H, W, 3) views, so that the split path runs (the JAX
    package's _SplitViews)."""

    def __init__(self, ds, num_splits: int):
        self.ds, self.num_splits = ds, num_splits

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        img, label = self.ds[i]
        return np.stack([img] * self.num_splits), label


def step_generators(seed: int, step: int, gen: torch.Generator
                    ) -> np.random.Generator:
    """Reseed ``gen`` (erasing boxes, DropPath masks) and return a numpy
    Generator (mixup, the erasing noise's seeds) for train step ``step``:
    the draws depend on (seed, step) alone, so a resumed run draws what
    the first would have."""
    ss = np.random.SeedSequence([seed, step])
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return np.random.default_rng(ss)


def train(args, args_text: str = "") -> dict:
    from lemevit_tpu_torch.data import native_decode
    from lemevit_tpu_torch.data.datasets import create_dataset
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.data.spawn import spec_for_split
    from lemevit_tpu_torch.data.mixup import (draw_erasing, random_erasing,
                                              row_noise)
    from lemevit_tpu_torch.data.device_aug import DeviceAug, center_crop
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    from lemevit_tpu_torch.train.checkpoint import (auto_resume,
                                                    load_pretrained,
                                                    restore_checkpoint,
                                                    save_checkpoint,
                                                    save_recovery)
    from lemevit_tpu_torch.train.optim import (PlateauController,
                                               build_lr_schedule,
                                               build_optimizer,
                                               plateau_scale,
                                               set_plateau_scale)
    from lemevit_tpu_torch.train.state import ModelEma, TrainState
    from lemevit_tpu_torch.parallel.distributed import (Shard,
                                                        all_reduce_sum,
                                                        init_distributed)
    from lemevit_tpu_torch.parallel.mesh import TP_ITEM
    from lemevit_tpu_torch.train.steps import (BatchAug,
                                               augmented_train_step,
                                               eval_metrics, jsd_train_step,
                                               stack_batch_stats)
    from lemevit_tpu_torch.utils.events import EventWriter
    from lemevit_tpu_torch.utils.logging import setup_logging
    from lemevit_tpu_torch.utils.meters import MetricTracker

    if args.mesh_model_axis > 1:
        raise SystemExit(
            f"--mesh-model-axis {args.mesh_model_axis}: tensor parallelism "
            f"is not ported ({TP_ITEM}); run data-parallel with 1")
    device = resolve_device(args.device)
    dist_info = init_distributed(device)
    rank, world = dist_info["process_index"], dist_info["process_count"]
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    primary = rank == 0
    shard = Shard(rank, world)
    out_dir = os.path.join(args.output, args.experiment or args.model)
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    logger = setup_logging(os.path.join(out_dir, "train.log"), rank=rank)
    if args_text and primary:
        with open(os.path.join(out_dir, "args.yaml"), "w") as f:
            f.write(args_text)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    amp = torch.bfloat16 if bf16 else None
    global_batch = args.batch_size * world * args.grad_accum_steps
    logger.info("device=%s bf16=%s processes=%d global_batch=%d",
                device, bf16, world, global_batch)

    # ---------------- data
    aug_splits = args.aug_splits if args.aug_splits > 1 else 0
    if aug_splits:
        if not args.jsd_loss:
            logger.info("aug-splits: training with the JSD loss (as the JAX "
                        "package, with or without --jsd-loss)")
        if args.mixup > 0 or args.cutmix > 0:
            logger.info("aug-splits: disabling mixup/cutmix (JSD path "
                        "takes hard targets, as in the reference)")
            args.mixup = args.cutmix = 0.0
    train_spec = val_spec = device_aug = None
    if args.synthetic:
        train_ds = create_dataset("synthetic", num_samples=global_batch * 8,
                                  image_size=args.img_size,
                                  num_classes=args.num_classes)
        val_ds = create_dataset("synthetic", num_samples=global_batch * 2,
                                image_size=args.img_size,
                                num_classes=args.num_classes)
        if aug_splits:
            train_ds = SplitViews(train_ds, aug_splits)
    else:
        if args.packed_data:
            if aug_splits:
                raise SystemExit("--packed-data does not support "
                                 "--aug-splits (AugMix/JSD runs on the host "
                                 "PIL pipeline)")
            device_aug = DeviceAug(
                args.img_size, hflip=args.hflip, auto_augment=args.aa,
                scale=tuple(args.scale))
        else:
            args.native_decode = native_decode.resolve(
                args.native_decode, auto=not aug_splits)
            if not os.path.isdir(args.data_dir):
                raise FileNotFoundError(
                    f"--data-dir {args.data_dir!r} is not a directory (pass "
                    "--synthetic for synthetic data)")
            if args.native_decode:
                logger.info("native decode plane on")
        # the spec builds the dataset here and in spawned workers alike
        train_spec = spec_for_split(args, args.train_split, train=True,
                                    aug_splits=aug_splits)
        val_spec = spec_for_split(args, args.val_split, train=False)
        train_ds, val_ds = train_spec.build(), val_spec.build()
        if device_aug is not None:
            logger.info("packed data plane: %d/%d samples @ %dpx, device "
                        "aug", len(train_ds), len(val_ds), train_ds.px)
        else:
            logger.info("data: %s %s, %d train / %d val samples",
                        args.dataset, args.data_dir, len(train_ds),
                        len(val_ds))
    procs = args.worker_procs if train_spec is not None else 0
    # each process loads its stride of every split
    train_loader = create_loader(
        train_ds, args.batch_size, is_training=True, seed=args.seed,
        num_threads=args.workers, num_procs=procs, dataset_spec=train_spec,
        device=device, rank=rank, world_size=world)
    val_loader = create_loader(
        val_ds, args.batch_size, num_threads=args.workers, num_procs=procs,
        dataset_spec=val_spec, device=device, rank=rank, world_size=world)
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
    if aug_splits:
        # S sets of BatchNorm statistics, before the restore: a checkpoint
        # of an aug-splits run holds all S
        stack_batch_stats(model, aug_splits)
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
            model, weight_decay=args.weight_decay, opt=args.opt,
            momentum=args.momentum),
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
    plateau_ctl = None
    if args.sched == "plateau":
        plateau_ctl = PlateauController(decay_rate=args.decay_rate,
                                        patience=args.patience_epochs)
        # a resumed run goes on from the scale its checkpoint holds
        plateau_ctl.scale = plateau_scale(state.optimizer)
    if dist_info["backend"] is not None:
        # a process group is open (one rank included): DDP, SyncBN within
        # the BatchNorms; they keep the buffers equal, so no broadcast
        from torch.nn.parallel import DistributedDataParallel
        state.ddp = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, broadcast_buffers=False)
    gen = torch.Generator(device=device)
    model.set_generator(gen, shard=(rank, world) if world > 1 else None)
    aug = BatchAug(args.num_classes, reprob=args.reprob, mixup=args.mixup,
                   cutmix=args.cutmix, mixup_prob=args.mixup_prob,
                   smoothing=args.smoothing)

    def full_train_step(batch):
        rng = step_generators(args.seed, state.step, gen)
        images = batch["image"]
        if device_aug is not None:
            # crop, flip and RandAugment on the device, drawn from gen
            images = device_aug(gen, images)
        images = normalize(images)
        labels = batch["label"]
        if aug_splits:
            # (B, S, H, W, C) -> (S, B, H, W, C); erasing per view
            images = images.transpose(0, 1)
            s, b, h, w, _ = images.shape
            if args.reprob > 0:
                # drawn for the (S, world B) views of the global batch;
                # this rank keeps its block of each split
                g = world * b

                def own(t):
                    return shard.rows(t.unflatten(0, (s, g)), 1).flatten(
                        0, 1)
                draw = {k: own(v) for k, v in draw_erasing(
                    gen, s * g, h, w, prob=args.reprob).items()}
                seeds = own(torch.from_numpy(rng.integers(2 ** 63,
                                                          size=s * g)))
                noise = row_noise(seeds, images.shape[2:], device)
                images = random_erasing(images.flatten(0, 1), draw,
                                        noise).unflatten(0, (s, b))
            return jsd_train_step(state, images, aug.soft_targets(labels),
                                  args.jsd_alpha, autocast_dtype=amp)
        return augmented_train_step(state, images, labels, aug, gen, rng,
                                    shard, autocast_dtype=amp)

    def evaluate(forward) -> dict:
        # device-side sums over this rank's stride, all-reduced and read
        # once at the end
        sums = torch.zeros(3, dtype=torch.float64, device=device)
        for batch in val_loader:
            if batch["image"].shape[0] != args.batch_size:
                continue  # the ragged tail, as the JAX package skips it
            images = batch["image"]
            if device_aug is not None:
                images = center_crop(images, args.img_size)
            with autocast():
                logits = forward(normalize(images))
            m = eval_metrics(logits, batch["label"])
            sums += torch.stack([torch.as_tensor(
                m[k], dtype=torch.float64, device=device)
                for k in ("top1_sum", "top5_sum", "count")])
        tot = dict(zip(("top1_sum", "top5_sum", "count"),
                       all_reduce_sum(sums).tolist()))
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

    events = EventWriter(out_dir, enabled=primary)
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
            if (args.recovery_interval and primary
                    and (step_i + 1) % args.recovery_interval == 0):
                save_recovery(ckpt_dir, state)
            if step_i % args.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = state.schedule(state.updates) * plateau_scale(
                    state.optimizer)
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
            result["samples_per_sec"] = (steady * args.batch_size * world
                                         / (t_end - t_warm))
            if aug_splits:
                result["views_per_sec"] = (result["samples_per_sec"]
                                           * aug_splits)

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
        if plateau_ctl is not None and eval_stats:
            scale = plateau_ctl.update(metric)
            set_plateau_scale(state.optimizer, scale)
            result["plateau_scale"] = scale
            if scale < 1.0:
                logger.info("plateau LR scale %.2e", scale)
        if primary:
            save_checkpoint(ckpt_dir, state, metric=metric,
                            max_history=args.checkpoint_hist)
        best_top1 = max(best_top1, metric)
        result["train_loss"] = tracker.summary().get("loss", float("nan"))
        row = {"epoch": epoch, "train_loss": result["train_loss"],
               "epoch_time_s": round(epoch_time, 1),
               **{k: round(v, 4) for k, v in eval_stats.items()}}
        if primary:
            write_header = not os.path.exists(summary_path)
            with open(summary_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=SUMMARY_FIELDS, restval="",
                                   extrasaction="ignore")
                if write_header:
                    w.writeheader()
                w.writerow(row)

    logger.info("done; best top1 %.3f", best_top1)
    return {"best_top1": best_top1, "steps": state.step,
            "processes": world, "ddp": state.ddp is not None, **result}


if __name__ == "__main__":
    main()
