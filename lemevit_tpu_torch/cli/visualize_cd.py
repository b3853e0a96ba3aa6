"""Change-detection predictions as PNGs: counterpart of
lemevit_tpu/cli/visualize_cd.py. Builds BIT over --backbone at the JAX
package's defaults (dec_depth 8, token_len 4), restores a cli.train_cd
checkpoint's weights, predicts the argmax class of every pair of
{data-dir}/{split} and writes it x255 as an 8-bit PNG under the pair's
name in --out (at most --limit of them when given). Runs on the card
unless --device cpu; bf16 autocast there as in cli.train_cd.

Usage:
  python -m lemevit_tpu_torch.cli.visualize_cd \\
      --checkpoint runs/cd/checkpoints/checkpoint-100.pth \\
      --data-dir /data/CDD --split test --out ./vis
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from lemevit_tpu_torch.attn.modules import BACKENDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="change-detection masks")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--backbone", default="lemevit_small")
    p.add_argument("--patch-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--out", default="./vis")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--attn-backend", default="auto", choices=list(BACKENDS))
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    from PIL import Image

    from lemevit_tpu_torch.cli.train_cd import (_collate, build_model,
                                                normalize_pair)
    from lemevit_tpu_torch.data.datasets import CDPairDataset
    from lemevit_tpu_torch.data.loader import create_loader
    from lemevit_tpu_torch.models.registry import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    bf16 = args.bf16 if args.bf16 is not None else device.type == "cuda"
    model = build_model(argparse.Namespace(
        head="bit", backbone=args.backbone, patch_size=args.patch_size,
        attn_backend=args.attn_backend, seed=0, dec_depth=8, token_len=4),
        device)
    ckpt = torch.load(args.checkpoint, map_location=device,
                      weights_only=True)
    model.load_state_dict(ckpt.get("state_dict", ckpt), strict=True)
    model.eval()

    ds = CDPairDataset(args.data_dir, args.split)
    loader = create_loader(ds, args.batch_size, collate_fn=_collate,
                           device=device)
    os.makedirs(args.out, exist_ok=True)
    ctx = (torch.autocast(device.type, dtype=torch.bfloat16) if bf16
           else contextlib.nullcontext())
    idx = 0
    with torch.inference_mode():
        for batch in loader:
            with ctx:
                logits = model(normalize_pair(batch["a"]),
                               normalize_pair(batch["b"]))
            pred = logits.argmax(-1).cpu().numpy()
            for i in range(pred.shape[0]):
                name = ds.names[idx] if idx < len(ds.names) else f"{idx}.png"
                Image.fromarray((pred[i] * 255).astype(np.uint8)).save(
                    os.path.join(args.out, name))
                idx += 1
                if args.limit and idx >= args.limit:
                    return idx
    print(f"wrote {idx} masks to {args.out}")
    return idx


if __name__ == "__main__":
    main()
