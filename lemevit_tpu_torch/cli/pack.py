"""Pack a class-per-directory image folder into the uint8 streaming cache
that ``--packed-data`` reads (data/packed.py); the flags of the JAX
package's scripts/pack.py.

Usage:
  python -m lemevit_tpu_torch.cli.pack --src /data/imagenet \\
      --out /data/imagenet_packed [--px 256] [--splits train validation]
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pack an image folder")
    p.add_argument("--src", required=True,
                   help="folder holding <split>/<class>/<image>")
    p.add_argument("--out", required=True)
    p.add_argument("--px", type=int, default=256,
                   help="side of the packed squares (>= img_size / crop_pct)")
    p.add_argument("--splits", nargs="*", default=["train", "validation"])
    return p


def main(argv=None) -> dict:
    """Pack each split found under --src; {split: meta}."""
    from lemevit_tpu_torch.data.packed import pack_folder

    args = build_parser().parse_args(argv)
    metas = {}
    for split in args.splits:
        src = os.path.join(args.src, split)
        if not os.path.isdir(src):
            print(f"skip {split}: {src} not found")
            continue
        metas[split] = meta = pack_folder(src, os.path.join(args.out, split),
                                          px=args.px)
        print(split, meta["n"], "samples @", meta["px"], "px")
    return metas


if __name__ == "__main__":
    main()
