"""Throughput benchmark CLI: the flags and ``--result`` JSON of
lemevit_tpu/cli/benchmark.py (samples/s, ms/step, parameter count, GMACs,
OOM batch-decay retry). ``--bench inference`` is ported; training is not.

Usage:
  python -m lemevit_tpu_torch.cli.benchmark --model lemevit_base --bench inference
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from lemevit_tpu_torch.attn.modules import BACKENDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch benchmark")
    p.add_argument("--model", default="lemevit_base")
    p.add_argument("--attn-backend", default="auto", choices=list(BACKENDS),
                   help="block dispatch: 'torch' bypasses the fused CUDA "
                        "kernels (escape hatch)")
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


def count_gmacs(model, img_size: int, device, dtype) -> float:
    """Multiply-adds of one image's forward (matmuls and convolutions),
    counted by torch.utils.flop_counter. It runs with autograd on, so the
    blocks take the plain composition: the fused kernels are opaque to the
    counter."""
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.zeros(1, img_size, img_size, 3, device=device, dtype=dtype)
    with FlopCounterMode(display=False) as fc:
        model(x)
    return fc.get_total_flops() / 2 / 1e9


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_inference(args, model, x):
    """Warm up, then time ``num_bench_iter`` forwards ending in a device
    synchronise. Returns (result dict, last logits)."""
    device = x.device
    with torch.inference_mode():
        for _ in range(max(args.num_warm_iter, 1)):
            out = model(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.num_bench_iter):
            out = model(x)
        _sync(device)
    step_time = (time.perf_counter() - t0) / max(args.num_bench_iter, 1)
    return {
        "samples_per_sec": round(args.batch_size / step_time, 2),
        "step_time": round(step_time * 1000, 3),
        "batch_size": args.batch_size,
        "img_size": args.img_size,
    }, out


def benchmark(args) -> dict:
    from lemevit_tpu_torch.models.registry import create_model, resolve_device

    if args.bench in ("train", "both"):
        raise NotImplementedError(
            "--bench train is not yet ported to lemevit_tpu_torch "
            "(inference only)")
    device = resolve_device(args.device)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    dtype = torch.bfloat16 if bf16 else torch.float32
    results = {"model": args.model}
    batch_size = args.batch_size
    while batch_size >= 1:
        try:
            args.batch_size = batch_size
            model = create_model(args.model, num_classes=args.num_classes,
                                 attn_backend=args.attn_backend,
                                 device=device, dtype=dtype).eval()
            results["param_count"] = round(
                sum(p.numel() for p in model.parameters()) / 1e6, 2)
            results["gmacs"] = round(
                count_gmacs(model, args.img_size, device, dtype), 2)
            g = torch.Generator().manual_seed(0)
            x = torch.randn(batch_size, args.img_size, args.img_size, 3,
                            generator=g).to(device)
            results["inference"], _ = run_inference(args, model, x)
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
