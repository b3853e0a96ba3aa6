"""Change-detection training and evaluation CLI: counterpart of
lemevit_tpu/cli/train_cd.py, with its flags, config files
(configs/cd/*.yaml), outputs and loop, plus ``--device`` (default cuda),
``--attn-backend`` and ``--seed``.

Reference contract (change_detection/{train,eval}.py): a BIT head over a
Siamese backbone (LeMeViT, ResNet or Swin; --head bit), or SNUNet-ECAM,
Siam-NestedUNet-Conc or SiamUnet-diff; AdamW with weight decay 0.01 on
every parameter (optax's default mask, eps 1e-8) at an LR falling linearly
from --lr to 0 over all steps; cross-entropy (``softmax_focal_loss`` at
gamma 0) or --loss hybrid (focal + dice), summed over the outputs of a
deep-supervision tuple; per-epoch precision / recall / F1 of the change
class on the val split (the last output of a tuple), the best checkpoint
kept by F1. Pairs are scaled by 1/255 only (no mean / std, as the
reference's CD transforms). Data: {data-dir}/{train,val}/{A,B,OUT}/*.png
(data/datasets.py::CDPairDataset; masks above 127 are change), or
--synthetic. bf16 autocast by default on CUDA; a LeMeViT backbone trains
and evaluates through the port's kernel dispatch.

The dropout of siamunet_diff, and DropPath in a Swin backbone, draw from
a generator seeded per step from (17, step); they cannot match the JAX
package's ``fold_in(PRNGKey(17), step)`` draws bit for bit (the JAX CLI
passes no generator to a Swin backbone's DropPath at all). A parameter
the forward does not reach (a LeMeViT backbone's unused last stage) gets
a zero gradient, so AdamW decays it as optax does.

Usage:
  python -m lemevit_tpu_torch.cli.train_cd \\
      --config configs/cd/bit_lemevit_small_cdd.yaml --data-dir /data/CDD
  python -m lemevit_tpu_torch.cli.train_cd --synthetic --epochs 1
  python -m lemevit_tpu_torch.cli.train_cd --synthetic --device cpu \\
      --backbone lemevit_micro --patch-size 32 --batch-size 2 \\
      --dec-depth 1 --epochs 1 --steps-per-epoch 2 --output /tmp/cd
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from lemevit_tpu_torch.attn.modules import BACKENDS

HEADS = ("bit", "snunet", "snunet_conc", "siamunet_diff")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch change "
                                            "detection")
    p.add_argument("--data-dir", default="")
    p.add_argument("--backbone", default="lemevit_small")
    p.add_argument("--head", default="bit", choices=list(HEADS))
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=2.4e-4)
    p.add_argument("--loss", default="ce", choices=["ce", "hybrid"])
    p.add_argument("--dec-depth", type=int, default=8)
    p.add_argument("--token-len", type=int, default=4)
    p.add_argument("--output", default="./output/cd")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--initial-checkpoint", default="",
                   help="pretrained backbone weights (.pth; --head bit)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps-per-epoch", type=int, default=0)
    p.add_argument("--eval-only", default="",
                   help="checkpoint to evaluate (skips training)")
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


class _SyntheticCD:
    """Random uint8 pairs; every odd sample has a changed top-left square
    (the JAX package's samples)."""

    def __init__(self, n, size):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        a = rng.randint(0, 256, (self.size, self.size, 3), np.uint8)
        b = a.copy()
        mask = np.zeros((self.size, self.size), np.uint8)
        if i % 2:
            s = self.size // 4
            b[:s, :s] = rng.randint(0, 256, (s, s, 3), np.uint8)
            mask[:s, :s] = 1
        return (a, b), mask


def _collate(samples) -> Dict[str, torch.Tensor]:
    """{"a", "b": uint8 (B, H, W, 3), "mask": int64 (B, H, W)}; a mask
    whose values pass 1 (a 0 / 255 PNG) is thresholded above 127."""
    pairs, masks = zip(*samples)

    def mask01(m):
        m = np.asarray(m)
        return (m > 127).astype(np.int64) if m.max() > 1 else m.astype(
            np.int64)

    return {"a": torch.from_numpy(np.stack(
                [np.asarray(p[0], np.uint8) for p in pairs])),
            "b": torch.from_numpy(np.stack(
                [np.asarray(p[1], np.uint8) for p in pairs])),
            "mask": torch.from_numpy(np.stack([mask01(m) for m in masks]))}


def prf1(tp, fp, fn) -> Dict[str, float]:
    p = tp / max(tp + fp, 1e-9)
    r = tp / max(tp + fn, 1e-9)
    f1 = 2 * p * r / max(p + r, 1e-9)
    return {"precision": p, "recall": r, "f1": f1}


def build_model(args, device=None) -> torch.nn.Module:
    """The --head model (BIT over --backbone, features_only) from
    --seed, on ``device``."""
    from lemevit_tpu_torch.models.registry import resolve_device
    from lemevit_tpu_torch.tasks import (SiamNestedUNetConc, SiamUnetDiff,
                                         SNUNetECAM, create_bit)
    from lemevit_tpu_torch.core.layers import init_weights
    if args.head == "bit":
        bb_kw = {}
        if args.backbone.startswith("swin"):
            bb_kw["img_size"] = args.patch_size
        elif args.backbone.startswith(("lemevit", "vit")):
            bb_kw["attn_backend"] = args.attn_backend
        return create_bit(args.backbone, device=device, seed=args.seed,
                          backbone_kwargs=bb_kw, dec_depth=args.dec_depth,
                          token_len=args.token_len)
    cls = {"snunet": SNUNetECAM, "snunet_conc": SiamNestedUNetConc,
           "siamunet_diff": SiamUnetDiff}[args.head]
    model = cls()
    init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(resolve_device(device))


def cd_loss(logits, mask: torch.Tensor, loss: str = "ce") -> torch.Tensor:
    """The CLI's loss of NHWC logits (a tensor or a deep-supervision
    tuple): CE (focal at gamma 0) summed over the outputs, or the hybrid
    focal + dice."""
    from lemevit_tpu_torch.ops.losses import hybrid_loss, softmax_focal_loss
    tup = logits if isinstance(logits, tuple) else (logits,)
    nchw = [lg.permute(0, 3, 1, 2).float() for lg in tup]
    if loss == "hybrid":
        return hybrid_loss(nchw, mask)
    return sum(softmax_focal_loss(lg, mask, gamma=0.0) for lg in nchw)


def normalize_pair(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float in [0, 1] (no mean / std)."""
    return u8.float() / 255.0


def step_generator(gen: torch.Generator, step: int) -> torch.Generator:
    """Reseed ``gen`` (dropout, DropPath) for train step ``step``."""
    ss = np.random.SeedSequence([17, step])
    return gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]))


def cd_train_step(model, optimizer, lr: float, batch: Dict[str, torch.Tensor],
                  loss: str = "ce",
                  autocast_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """One update: the train-mode forward of the pair (under autocast when
    given), the loss, backward, AdamW at ``lr`` over every parameter
    (unreached ones with zero gradients). Returns the loss."""
    model.train()
    ctx = (torch.autocast(batch["a"].device.type, dtype=autocast_dtype)
           if autocast_dtype is not None else contextlib.nullcontext())
    with ctx:
        logits = model(normalize_pair(batch["a"]), normalize_pair(batch["b"]))
    value = cd_loss(logits, batch["mask"], loss)
    value.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return value.detach()


@torch.no_grad()
def confusion(model, batch, autocast_dtype=None) -> torch.Tensor:
    """(tp, fp, fn) of the change class on one batch, device int64: the
    argmax of the last output of a tuple."""
    model.eval()
    ctx = (torch.autocast(batch["a"].device.type, dtype=autocast_dtype)
           if autocast_dtype is not None else contextlib.nullcontext())
    with ctx:
        logits = model(normalize_pair(batch["a"]), normalize_pair(batch["b"]))
    if isinstance(logits, tuple):
        logits = logits[-1]
    pred, gt = logits.argmax(-1), batch["mask"]
    return torch.stack([((pred == 1) & (gt == 1)).sum(),
                        ((pred == 1) & (gt == 0)).sum(),
                        ((pred == 0) & (gt == 1)).sum()])


def main(argv=None) -> dict:
    from lemevit_tpu_torch.utils.parser import parse_args_with_config
    args, args_text = parse_args_with_config(build_parser(), argv)
    return train(args, args_text)


def train(args, args_text: str = "") -> dict:
    from lemevit_tpu_torch.core.layers import set_generator
    from lemevit_tpu_torch.data.datasets import CDPairDataset
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.models.registry import resolve_device
    from lemevit_tpu_torch.train.checkpoint import (load_backbone,
                                                    restore_checkpoint,
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
    logger.info("device=%s bf16=%s head=%s backbone=%s", device, bf16,
                args.head, args.backbone)

    if args.synthetic:
        train_ds = _SyntheticCD(4 * args.batch_size, args.patch_size)
        val_ds = _SyntheticCD(2 * args.batch_size, args.patch_size)
    else:
        train_ds = CDPairDataset(args.data_dir, "train")
        val_ds = CDPairDataset(args.data_dir, "val")
    train_loader = create_loader(train_ds, args.batch_size, is_training=True,
                                 seed=args.seed, num_threads=args.workers,
                                 collate_fn=_collate, device=device)
    val_loader = create_loader(val_ds, args.batch_size,
                               num_threads=args.workers, collate_fn=_collate,
                               device=device)
    steps_per_epoch = args.steps_per_epoch or max(len(train_loader), 1)

    model = build_model(args, device)
    if args.initial_checkpoint and args.head == "bit":
        load_backbone(model.backbone, args.initial_checkpoint)
    total_steps = max(args.epochs * steps_per_epoch, 1)

    def sched(t: int) -> float:  # optax.linear_schedule(lr, 0, total)
        return args.lr * (1.0 - min(t, total_steps) / total_steps)

    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    state = TrainState(model=model, optimizer=optimizer, schedule=sched)
    gen = torch.Generator(device=device)
    set_generator(model, gen)

    def evaluate() -> dict:
        tot = torch.zeros(3, dtype=torch.int64, device=device)
        for batch in val_loader:
            tot += confusion(model, batch, amp)
        model.train()
        return prf1(*[int(v) for v in tot.tolist()])

    if args.eval_only:
        restore_checkpoint(args.eval_only, state)
        metrics = evaluate()
        print(json.dumps(metrics, indent=2))
        return metrics

    timer = StepTimer(device)
    best_f1 = -1.0
    loss = torch.zeros(())
    metrics: dict = {}
    for epoch in range(args.epochs):
        train_loader.set_epoch(epoch)
        it = iter(train_loader)
        for si in range(steps_per_epoch):
            batch = next(it, None)
            if batch is None:  # more steps than batches: start over
                it = iter(train_loader)
                batch = next(it)
            timed = state.step > 0  # the steady window: steps 2..n
            if timed:
                timer.start()
            step_generator(gen, state.step)
            loss = cd_train_step(model, optimizer, sched(state.step), batch,
                                 args.loss, amp)
            state.step += 1
            if timed:
                timer.stop()
        it.close()
        metrics = evaluate()
        logger.info("epoch %d loss %.4f %s", epoch, float(loss),
                    json.dumps({k: round(v, 4) for k, v in metrics.items()}))
        if metrics["f1"] > best_f1:
            best_f1 = metrics["f1"]
            save_checkpoint(os.path.join(args.output, "checkpoints"), state,
                            metric=metrics["f1"])
    logger.info("best F1 %.4f", best_f1)
    steady = sum(timer.times)
    return {"best_f1": best_f1, "final_metrics": metrics,
            "loss": float(loss), "steps": state.step,
            "pairs_per_sec": (len(timer.times) * args.batch_size / steady
                              if steady else None),
            "step_ms": timer.mean_ms if timer.times else None}


if __name__ == "__main__":
    main()
