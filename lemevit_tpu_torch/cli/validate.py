"""Evaluation CLI: the flags and ``--result`` JSON of
lemevit_tpu/cli/validate.py (model + checkpoint -> top-1 / top-5 / loss).
Ported: ``--synthetic`` data, ``--checkpoint`` (reference-named .pth),
``--use-ema``, ``--tta``, ``--bulk``. Image folders, packed caches, native
decode and ReaL labels are not ported yet and raise.

Usage:
  python -m lemevit_tpu_torch.cli.validate --model lemevit_base --synthetic
  python -m lemevit_tpu_torch.cli.validate --model lemevit_base --synthetic --s-stage --cpe-in-kernel
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lemevit_tpu_torch validation")
    p.add_argument("--model", default="lemevit_tiny")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--data-dir", default="")
    p.add_argument("--dataset", default="imagefolder")
    p.add_argument("--split", default="validation")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--crop-pct", type=float, default=0.9)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--native-decode", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--packed-data", default="")
    p.add_argument("--s-stage", action="store_true",
                   help="inference: each S stage of 2+ blocks in one "
                        "s_stage kernel launch (the JAX PB_S_STAGE=1)")
    p.add_argument("--cpe-in-kernel", action="store_true",
                   help="inference: the block kernels apply the 3x3 CPE "
                        "to pre-CPE tokens (the JAX PB_{S,D,C}_CPE=1)")
    p.add_argument("--bf16", action="store_true", default=None,
                   help="bfloat16 weights and activations (default on CUDA)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--results-file", default="")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data smoke mode")
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--passes", type=int, default=1)
    p.add_argument("--tta", action="store_true",
                   help="average logits with the horizontal flip")
    p.add_argument("--real-labels", default="")
    p.add_argument("--bulk", default="",
                   help="directory/glob of checkpoints to validate in turn")
    return p


def validate(args) -> dict:
    from lemevit_tpu_torch.data.datasets import create_dataset
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    from lemevit_tpu_torch.train.checkpoint import load_pretrained
    from lemevit_tpu_torch.train.steps import eval_metrics

    if not args.synthetic or args.packed_data or args.real_labels:
        raise NotImplementedError(
            "only --synthetic data is ported to lemevit_tpu_torch yet "
            "(no image folders, packed caches or ReaL labels)")
    device = resolve_device(args.device)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = create_model(args.model, num_classes=args.num_classes,
                         s_stage=args.s_stage,
                         cpe_in_kernel=args.cpe_in_kernel,
                         device=device, dtype=dtype)
    if args.checkpoint:
        load_pretrained(model, args.checkpoint, use_ema=args.use_ema)
    model.eval()
    dataset = create_dataset("synthetic", num_samples=4 * args.batch_size,
                             image_size=args.img_size,
                             num_classes=args.num_classes)

    def step(images_u8, labels):
        images = normalize(images_u8, dtype=dtype)
        logits = model(images)
        if args.tta:
            logits = (logits + model(images.flip(2))) / 2.0
        return eval_metrics(logits, labels)

    with torch.inference_mode():
        # warm-up outside the timed loop
        step(torch.zeros(args.batch_size, args.img_size, args.img_size, 3,
                         dtype=torch.uint8, device=device),
             torch.zeros(args.batch_size, dtype=torch.int64, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        sums = {"loss_sum": 0.0, "top1_sum": 0, "top5_sum": 0, "count": 0}
        n_batches = 0
        done = False
        for _ in range(max(1, args.passes)):
            for batch in create_loader(dataset, args.batch_size, device):
                m = step(batch["image"], batch["label"])
                for k in sums:  # device-side sums; read once at the end
                    sums[k] = sums[k] + m[k]
                n_batches += 1
                if args.max_batches and n_batches >= args.max_batches:
                    done = True
                    break
            if done:
                break
        totals = {k: float(v) for k, v in sums.items()}
    dt = time.perf_counter() - t0
    cnt = max(totals["count"], 1)
    return {
        "model": args.model,
        "top1": round(100.0 * totals["top1_sum"] / cnt, 4),
        "top5": round(100.0 * totals["top5_sum"] / cnt, 4),
        "loss": round(totals["loss_sum"] / cnt, 4),
        "img_size": args.img_size,
        "crop_pct": args.crop_pct,
        "samples_per_sec": round(cnt / dt, 2),
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.bulk:
        import glob
        paths = sorted(glob.glob(args.bulk)) or sorted(
            os.path.join(args.bulk, p) for p in os.listdir(args.bulk))
        all_results = []
        for p in paths:
            args.checkpoint = p
            r = validate(args)
            r["checkpoint"] = p
            all_results.append(r)
            print(json.dumps(r))
        best = max(all_results, key=lambda r: r["top1"])
        print(f"--result\n{json.dumps(best, indent=2)}")
        if args.results_file:
            with open(args.results_file, "w") as f:
                json.dump(all_results, f, indent=2)
        return best
    results = validate(args)
    if args.results_file:
        with open(args.results_file, "w") as f:
            json.dump(results, f, indent=2)
    print(f"--result\n{json.dumps(results, indent=2)}")
    return results


if __name__ == "__main__":
    main()
