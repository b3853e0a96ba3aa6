"""One rank of tests/test_torch_parallel.py's two-process gloo job (run as
``python -m tests.torch_parallel_worker <dir>`` with RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT set). Imports torch and the port only. Reads
<dir>/inputs.npz and writes <dir>/rank<r>.npz:
  - SyncBN: core/layers.py::BatchNorm in train mode on this rank's rows of
    a global batch, plain and split (3 splits); the output, the input's
    gradient of sum(y * G), the all-reduced weight and bias gradients and
    the running statistics;
  - two train steps of lemevit_micro through train/steps.py::
    augmented_train_step on this rank's block of the global batch, with
    erasing, mixup / cutmix and DropPath (losses, grad norms, parameters);
  - cli.train runs at --grad-accum-steps 1 and 2 (rank r writes under
    <dir>/cli<k>/r<r>; only rank 0 may write anything), and one that
    resumes the one-process checkpoint named in <dir>/resume_from.txt for
    a second epoch (under <dir>/resume/r<r>).
"""
import os
import sys

import numpy as np
import torch


def syncbn(inp, rank, world, mode):
    from lemevit_tpu_torch.core.layers import BatchNorm
    x = inp[f"bn_{mode}_x"]                  # (S, G, C, H, W)
    s, g = x.shape[:2]
    b = g // world
    rows = slice(rank * b, (rank + 1) * b)
    bn = BatchNorm(x.shape[2], eps=1e-5)
    if s > 1:
        bn.set_splits(s)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_b"]))
        bn.running_mean.copy_(torch.from_numpy(inp[f"bn_{mode}_rm"]))
        bn.running_var.copy_(torch.from_numpy(inp[f"bn_{mode}_rv"]))
    xr = torch.from_numpy(np.ascontiguousarray(
        x[:, rows].reshape((-1,) + x.shape[2:]))).requires_grad_(True)
    y = bn.train()(xr)
    cot = torch.from_numpy(np.ascontiguousarray(
        inp[f"bn_{mode}_g"][:, rows].reshape(y.shape)))
    (y * cot).sum().backward()
    wg, bg = bn.weight.grad.clone(), bn.bias.grad.clone()
    torch.distributed.all_reduce(wg)
    torch.distributed.all_reduce(bg)
    return {f"{mode}_y": y.detach().numpy(), f"{mode}_dx": xr.grad.numpy(),
            f"{mode}_dw": wg.numpy(), f"{mode}_db": bg.numpy(),
            f"{mode}_rm": bn.running_mean.numpy(),
            f"{mode}_rv": bn.running_var.numpy()}


STEPS, SEED, NUM_CLASSES = 2, 11, 10


def run_steps(inp, shard):
    """STEPS train steps of lemevit_micro (DropPath 0.2) with erasing,
    mixup / cutmix and label smoothing on ``shard``'s rows of the global
    batches inp["images"][step] / inp["labels"][step], DDP-wrapped with
    more than one rank. Returns the losses, grad norms and the final
    state_dict as numpy."""
    from lemevit_tpu_torch.cli.train import step_generators
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.models.registry import create_model
    from lemevit_tpu_torch.train.optim import (build_lr_schedule,
                                               build_optimizer)
    from lemevit_tpu_torch.train.state import TrainState
    from lemevit_tpu_torch.train.steps import BatchAug, augmented_train_step
    model = create_model("lemevit_micro", num_classes=NUM_CLASSES,
                         drop_path_rate=0.2, device="cpu", seed=3)
    state = TrainState(model, build_optimizer(model), build_lr_schedule(
        base_lr=1e-3, global_batch_size=512, steps_per_epoch=STEPS,
        epochs=2, warmup_epochs=0))
    if shard.world > 1:
        from torch.nn.parallel import DistributedDataParallel
        state.ddp = DistributedDataParallel(model, broadcast_buffers=False)
    gen = torch.Generator()
    model.set_generator(gen, (shard.rank, shard.world)
                        if shard.world > 1 else None)
    aug = BatchAug(NUM_CLASSES, reprob=0.5, mixup=0.8, cutmix=1.0,
                   mixup_prob=1.0, smoothing=0.1)
    losses, gnorms = [], []
    for step in range(STEPS):
        images = shard.rows(normalize(torch.from_numpy(
            inp["images"][step])))
        labels = shard.rows(torch.from_numpy(inp["labels"][step]))
        rng = step_generators(SEED, state.step, gen)
        m = augmented_train_step(state, images, labels, aug, gen, rng, shard)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    out = {"step_losses": np.array(losses), "step_gnorms": np.array(gnorms)}
    for k, v in model.state_dict().items():
        out[f"p:{k}"] = v.detach().numpy()
    return out


def cli_args(accum, output, batch):
    """cli.train on synthetic data, lemevit_micro at 32 px, 2 steps,
    augmentations off, evaluated, at per-process ``batch``."""
    return ["--synthetic", "--model", "lemevit_micro", "--img-size", "32",
            "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "2",
            "--log-interval", "1", "--mixup", "0", "--cutmix", "0",
            "--reprob", "0", "--drop-path", "0", "--workers", "1",
            "--num-classes", "10", "--batch-size", str(batch),
            "--grad-accum-steps", str(accum), "--output", output]


def main(out):
    from lemevit_tpu_torch.parallel.distributed import (Shard,
                                                        init_distributed)
    info = init_distributed("cpu", timeout_s=60)
    rank, world = info["process_index"], info["process_count"]
    inp = dict(np.load(os.path.join(out, "inputs.npz")))
    res = {"world": np.array(world)}
    for mode in ("plain", "split"):
        res.update(syncbn(inp, rank, world, mode))
    res.update(run_steps(inp, Shard(rank, world)))
    from lemevit_tpu_torch.cli import train
    for k in (1, 2):
        r = train.main(cli_args(k, os.path.join(out, f"cli{k}", f"r{rank}"),
                                batch=2))
        res[f"cli{k}_processes"] = np.array(r["processes"])
    # a one-process checkpoint resumed by both ranks for a second epoch
    with open(os.path.join(out, "resume_from.txt")) as f:
        ckpt = f.read().strip()
    r = train.main(cli_args(1, os.path.join(out, "resume", f"r{rank}"),
                            batch=2) + ["--resume", ckpt, "--epochs", "2"])
    res["resume_steps"] = np.array(r["steps"])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
