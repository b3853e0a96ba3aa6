"""Evaluation CLI: the flags and ``--result`` JSON of
lemevit_tpu/cli/validate.py (model + checkpoint -> top-1 / top-5 / loss).

Data: an image folder, a zip (zipfolder), a remote-sensing manifest
(ucm, aid, nwpu, millionaid) or hub and shard data (hfds/, tfds/, wds)
through the centre crop at --crop-pct and the threaded loader, or
--synthetic. --native-decode crops in C++ (data/native_decode.py), on by
default where its library builds. --packed-data <dir> reads the split of a
packed cache (cli/pack.py) and, on the device, resizes its squares to
int(img_size / crop_pct) (bicubic, as jax.image.resize) and takes the
centre crop. The last batch may be short (no padding). ``--real-labels``
rescores top-1 against ImageNet-ReaL labels (``real_top1``), keyed by
image file name. Also ``--checkpoint`` (reference-named .pth),
``--use-ema``, ``--tta``, ``--bulk``.

Usage:
  python -m lemevit_tpu_torch.cli.validate --model lemevit_base \\
      --data-dir /data/imagenet --checkpoint weights.pth
  python -m lemevit_tpu_torch.cli.validate --model lemevit_base --synthetic
  python -m lemevit_tpu_torch.cli.validate --model lemevit_base --synthetic --s-stage --cpe-in-kernel
  python -m lemevit_tpu_torch.cli.validate --model lemevit_base \\
      --packed-data /data/packed --checkpoint weights.pth
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import torch

from lemevit_tpu_torch.attn.modules import BACKENDS


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
                   default=None,
                   help="C++ decode + centre crop; default on when its "
                        "library builds, an explicit --native-decode "
                        "raises when it does not")
    p.add_argument("--packed-data", default="",
                   help="packed uint8 cache dir (cli.pack); resize and "
                        "centre crop on the device")
    p.add_argument("--attn-backend", default="auto", choices=list(BACKENDS),
                   help="block dispatch: 'torch' composes every block in "
                        "plain PyTorch instead of the CUDA kernels")
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


def load_real_labels(path: str) -> Dict[str, List[int]]:
    """ImageNet-ReaL labels keyed by image file name: a JSON object
    {name: [labels]} as it stands, or real.json's list (one entry per
    validation image, in ILSVRC2012_val_%08d.JPEG order)."""
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        return raw
    return {f"ILSVRC2012_val_{i + 1:08d}.JPEG": labels
            for i, labels in enumerate(raw)}


def validate(args, logits: Optional[list] = None) -> dict:
    """The ``--result`` dict of ``args``; when ``logits`` is a list, each
    batch's logits (fp32, on the device) are appended to it."""
    from lemevit_tpu_torch.data import native_decode
    from lemevit_tpu_torch.data.datasets import create_dataset
    from lemevit_tpu_torch.data.device_aug import center_crop, resize_square
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.data.spawn import spec_for_split
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.models.registry import create_model, resolve_device
    from lemevit_tpu_torch.train.checkpoint import load_pretrained
    from lemevit_tpu_torch.train.steps import eval_metrics

    device = resolve_device(args.device)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = create_model(args.model, num_classes=args.num_classes,
                         attn_backend=args.attn_backend,
                         s_stage=args.s_stage,
                         cpe_in_kernel=args.cpe_in_kernel,
                         device=device, dtype=dtype)
    if args.checkpoint:
        load_pretrained(model, args.checkpoint, use_ema=args.use_ema)
    model.eval()
    packed = bool(args.packed_data) and not args.synthetic
    if args.synthetic:
        dataset = create_dataset("synthetic", num_samples=4 * args.batch_size,
                                 image_size=args.img_size,
                                 num_classes=args.num_classes)
    elif packed:
        dataset = spec_for_split(args, args.split, train=False).build()
    else:
        args.native_decode = native_decode.resolve(args.native_decode)
        if not os.path.isdir(args.data_dir):
            raise FileNotFoundError(
                f"--data-dir {args.data_dir!r} is not a directory (pass "
                "--synthetic for synthetic data)")
        dataset = spec_for_split(args, args.split, train=False).build()
    real = None
    if args.real_labels:
        real = load_real_labels(args.real_labels)
        # ReaL is keyed by file name, not by the dataset's class-major order
        names = [os.path.basename(p) for p, _ in getattr(dataset, "samples",
                                                         [])]
        if not names:
            raise ValueError("--real-labels needs a dataset with .samples "
                             f"paths (got {type(dataset).__name__})")
    loader = create_loader(dataset, args.batch_size,
                           num_threads=args.workers, device=device)

    # the packed squares are resized to the eval transform's short side
    # (floor, as transforms.center_crop_resize) before the centre crop
    resize_to = int(args.img_size / args.crop_pct)

    def step(images_u8, labels):
        if packed:
            if resize_to != images_u8.shape[1]:
                images_u8 = torch.clamp(torch.round(resize_square(
                    images_u8.to(torch.float32), resize_to)), 0, 255)
            images_u8 = center_crop(images_u8, args.img_size)
        images = normalize(images_u8, dtype=dtype)
        out = model(images)
        if args.tta:
            out = (out + model(images.flip(2))) / 2.0
        return eval_metrics(out, labels), out

    def batches():
        for _ in range(max(1, args.passes)):
            yield from loader

    with torch.inference_mode():
        # warm-up outside the timed loop
        px = dataset.px if packed else args.img_size
        step(torch.zeros(args.batch_size, px, px, 3,
                         dtype=torch.uint8, device=device),
             torch.zeros(args.batch_size, dtype=torch.int64, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        sums = {"loss_sum": 0.0, "top1_sum": 0, "top5_sum": 0, "count": 0}
        real_correct = real_count = seen = 0
        it = batches()
        try:
            for n_batches, batch in enumerate(it, 1):
                m, out = step(batch["image"], batch["label"])
                if logits is not None:
                    logits.append(out.float())
                for k in sums:  # device-side sums; read once at the end
                    sums[k] = sums[k] + m[k]
                if real is not None:
                    for p in out.argmax(-1).tolist():
                        ok = real.get(names[seen] if seen < len(names)
                                      else "", [])
                        if ok:  # ReaL skips images with no label
                            real_correct += int(p in ok)
                            real_count += 1
                        seen += 1
                if args.max_batches and n_batches >= args.max_batches:
                    break
        finally:
            it.close()
        totals = {k: float(v) for k, v in sums.items()}
    dt = time.perf_counter() - t0
    cnt = max(totals["count"], 1)
    results = {
        "model": args.model,
        "top1": round(100.0 * totals["top1_sum"] / cnt, 4),
        "top5": round(100.0 * totals["top5_sum"] / cnt, 4),
        "loss": round(totals["loss_sum"] / cnt, 4),
        "count": int(totals["count"]),
        "img_size": args.img_size,
        "crop_pct": args.crop_pct,
        "samples_per_sec": round(cnt / dt, 2),
    }
    if real is not None and real_count:
        results["real_top1"] = round(100.0 * real_correct / real_count, 4)
    return results


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
