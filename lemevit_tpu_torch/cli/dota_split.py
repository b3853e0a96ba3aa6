"""Materialize a tiled DOTA dataset from original-size images; counterpart
of lemevit_tpu/cli/dota_split.py (BboxToolkit's img_split step, which
produces the reference's datasets/DOTA_1024 layout,
object_detection/configs/obb/_base_/datasets/dota.py):

  python -m lemevit_tpu_torch.cli.dota_split --src /data/DOTA \\
      --dst /data/DOTA_1024 --splits train,val --size 1024 --gap 200
"""
from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="DOTA img_split equivalent")
    p.add_argument("--src", required=True,
                   help="original DOTA root ({src}/{split}/images + "
                        "annfiles|labelTxt)")
    p.add_argument("--dst", required=True)
    p.add_argument("--splits", default="train,val")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--gap", type=int, default=200)
    p.add_argument("--iof-thr", type=float, default=0.7)
    p.add_argument("--keep-empty", action="store_true",
                   help="also write tiles with no (kept) objects")
    p.add_argument("--limit", type=int, default=0,
                   help="only the first N source images (debug)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from lemevit_tpu_torch.data.dota_split import split_dataset

    totals = {}
    for split in args.splits.split(","):
        n = split_dataset(args.src, args.dst, split=split, size=args.size,
                          gap=args.gap, iof_thr=args.iof_thr,
                          keep_empty=args.keep_empty,
                          limit=args.limit or None)
        print(f"{split}: {n} tiles")
        totals[split] = n
    return totals


if __name__ == "__main__":
    main()
