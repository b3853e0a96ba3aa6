"""Throughput benchmark CLI: the flags and ``--result`` JSON of
lemevit_tpu/cli/benchmark.py (samples/s, ms/step, parameter count, GMACs,
OOM batch-decay retry), for ``--bench inference``, ``train`` and ``both``.

Inference runs a model with bf16 weights (the CUDA default) in eval mode;
training keeps float32 parameters and runs the step under bf16 autocast, as
cli/train.py does (flax's ``dtype=bfloat16``), so the blocks go through the
hand-written training kernels.

Usage:
  python -m lemevit_tpu_torch.cli.benchmark --model lemevit_base --bench inference
  python -m lemevit_tpu_torch.cli.benchmark --model lemevit_base --bench inference --s-stage --cpe-in-kernel
  python -m lemevit_tpu_torch.cli.benchmark --model lemevit_tiny --bench train --batch-size 64
  python -m lemevit_tpu_torch.cli.benchmark --model lemevit_tiny --bench train --batch-size 64 --train-cpe-in-kernel
"""
from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from lemevit_tpu_torch.attn.modules import BACKENDS
from lemevit_tpu_torch.utils.profiling import StepTimer, cost_analysis


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch benchmark")
    p.add_argument("--model", default="lemevit_base")
    p.add_argument("--attn-backend", default="auto", choices=list(BACKENDS),
                   help="block dispatch: 'torch' bypasses the fused CUDA "
                        "kernels (escape hatch)")
    p.add_argument("--s-stage", action="store_true",
                   help="inference: each S stage of 2+ blocks in one "
                        "s_stage kernel launch (the JAX PB_S_STAGE=1)")
    p.add_argument("--cpe-in-kernel", action="store_true",
                   help="inference: the block kernels apply the 3x3 CPE "
                        "to pre-CPE tokens (the JAX PB_{S,D,C}_CPE=1)")
    p.add_argument("--train-cpe-in-kernel", action="store_true",
                   help="training: the training kernels apply the 3x3 CPE "
                        "to pre-CPE tokens (the JAX PB_TRAIN_CPE=fused)")
    p.add_argument("--bench", default="inference",
                   choices=["inference", "train", "both", "profile"])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--num-warm-iter", type=int, default=3)
    p.add_argument("--num-bench-iter", type=int, default=30)
    p.add_argument("--bf16", action="store_true", default=None,
                   help="bfloat16 weights and activations (default on CUDA)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--results-file", default="")
    return p


def run_inference(args, model, x):
    """Warm up, then time ``num_bench_iter`` forwards ending in a device
    synchronise. Returns (result dict, last logits)."""
    timer = StepTimer(x.device)
    with torch.inference_mode():
        for _ in range(max(args.num_warm_iter, 1)):
            out = model(x)
        timer.start()
        for _ in range(args.num_bench_iter):
            out = model(x)
        step_time = timer.stop() / max(args.num_bench_iter, 1)
    return {
        "samples_per_sec": round(args.batch_size / step_time, 2),
        "step_time": round(step_time * 1000, 3),
        "batch_size": args.batch_size,
        "img_size": args.img_size,
    }, out


def run_train(args, model, x, autocast_dtype=None) -> dict:
    """lemevit_tpu/cli/benchmark.py::run_train: AdamW at 1e-3 and train_step
    on fixed labels; one warm step, then ``num_bench_iter`` steps ending in
    a device synchronise; then as many eval forwards for ``fwd_time``.
    ``model`` holds float32 parameters; the steps and forwards run under
    autocast to ``autocast_dtype`` where given."""
    from lemevit_tpu_torch.train.optim import build_optimizer
    from lemevit_tpu_torch.train.state import TrainState
    from lemevit_tpu_torch.train.steps import train_step

    device = x.device
    timer = StepTimer(device)
    state = TrainState(model, build_optimizer(model), lambda u: 1e-3)
    labels = torch.from_numpy(np.random.RandomState(0).randint(
        0, args.num_classes, args.batch_size)).to(device)
    n = max(args.num_bench_iter, 1)
    train_step(state, x, labels, autocast_dtype=autocast_dtype)
    timer.start()
    for _ in range(n):
        train_step(state, x, labels, autocast_dtype=autocast_dtype)
    dt = timer.stop() / n

    autocast = (torch.autocast(device.type, dtype=autocast_dtype)
                if autocast_dtype is not None else contextlib.nullcontext())
    model.eval()
    with torch.inference_mode(), autocast:
        model(x)
        timer.start()
        for _ in range(n):
            model(x)
        dt_fwd = timer.stop() / n
    model.train()
    return {
        "samples_per_sec": round(args.batch_size / dt, 2),
        "step_time": round(dt * 1000, 3),
        "fwd_time": round(dt_fwd * 1000, 3),
        "bwd_opt_time": round((dt - dt_fwd) * 1000, 3),
        "batch_size": args.batch_size,
    }


def benchmark(args) -> dict:
    from lemevit_tpu_torch.models.registry import create_model, resolve_device

    device = resolve_device(args.device)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    dtype = torch.bfloat16 if bf16 else torch.float32
    results = {"model": args.model}
    batch_size = args.batch_size
    while batch_size >= 1:
        try:
            args.batch_size = batch_size

            def make(dt):
                return create_model(args.model, num_classes=args.num_classes,
                                     attn_backend=args.attn_backend,
                                     s_stage=args.s_stage,
                                     cpe_in_kernel=args.cpe_in_kernel,
                                     train_cpe_in_kernel=(
                                         args.train_cpe_in_kernel),
                                     device=device, dtype=dt)
            g = torch.Generator().manual_seed(0)
            x = torch.randn(batch_size, args.img_size, args.img_size, 3,
                            generator=g).to(device)
            # inference keeps ``dtype`` weights, training float32 ones
            infer = args.bench in ("inference", "both", "profile")
            model_dtype = dtype if infer else torch.float32
            model = make(model_dtype)
            results["param_count"] = round(
                sum(p.numel() for p in model.parameters()) / 1e6, 2)
            results["gmacs"] = round(cost_analysis(
                model, args.img_size, device, model_dtype)["gmacs"], 2)
            if infer:
                results["inference"], _ = run_inference(args, model.eval(), x)
            if args.bench in ("train", "both"):
                if infer:
                    del model
                    model = make(torch.float32)
                results["train"] = run_train(
                    args, model.train(), x, torch.bfloat16 if bf16 else None)
            results["device"] = (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu")
            break
        except torch.cuda.OutOfMemoryError:
            if batch_size == 1:
                raise
            batch_size //= 2  # OOM retry with batch decay
            torch.cuda.empty_cache()
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = benchmark(args)
    if args.results_file:
        with open(args.results_file, "w") as f:
            json.dump(results, f, indent=2)
    print(f"--result\n{json.dumps(results, indent=2)}")
    return results


if __name__ == "__main__":
    main()
