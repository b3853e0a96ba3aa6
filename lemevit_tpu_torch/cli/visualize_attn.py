"""Attention-map visualization (the reference vis.ipynb surface):
counterpart of lemevit_tpu/cli/visualize_attn.py, with its flags and
PNGs, plus ``--device`` (default cuda).

The Dual Cross-Attention maps of one block of a D stage: how each meta
token attends over the image positions (c <- x, averaged over the heads)
and the entropy of how each image position attends over the meta tokens
(x <- c), recomputed from the block's inputs with its trained
projections. The inputs come from a forward of the model with
models/lemevit.py::capture_block_inputs (forward pre-hooks, the JAX
package's ``sow``); then the CPE and the pre-norm as the block applies
them, the projections of ``qkv1`` / ``qkv2`` (``qv1`` / ``kv2`` for a D2
block, whose "keys" are then the JAX package's columns ch:2 ch, the
values), the scales of attn/reference.py::dca_scales and a float32
softmax. One PNG per meta token and one of the entropy: the map
min-max normalised, repeated up to the image and laid over its red
channel.

Usage:
  python -m lemevit_tpu_torch.cli.visualize_attn --image cat.jpg \\
      --checkpoint weights.pth --model lemevit_tiny --stage 1 --block 0 \\
      --out ./attn_vis
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--model", default="lemevit_tiny")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--stage", type=int, default=1, help="a 'D' stage (1/2)")
    p.add_argument("--block", type=int, default=0)
    p.add_argument("--out", default="./attn_vis")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def attention_maps(model, x: torch.Tensor, stage: int, block: int,
                   head_dim: int):
    """(c <- x maps (heads, M, N), x <- c maps (heads, N, M), (H, W)) of
    block ``block`` of ``stage`` for the normalized NHWC batch ``x``
    (its first image)."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    from lemevit_tpu_torch.models.lemevit import capture_block_inputs
    with torch.no_grad(), capture_block_inputs(model) as inputs:
        model(x)
    x_in, c_in = inputs[sum(model.depth[:stage]) + block]
    blk = model.stages[stage][block]
    b, h, w, ch = x_in.shape
    heads = ch // head_dim
    with torch.no_grad():
        xn = blk._norm_in(blk._cpe(x_in).reshape(b, h * w, ch)).float()
        cn = blk._norm_in(c_in).float()
        a = blk.attn
        p1, p2 = ((a.qkv1, a.qkv2) if blk.attn_type == "D"
                  else (a.qv1, a.kv2))
        t1 = torch.nn.functional.linear(xn, p1.weight.float(),
                                        p1.bias.float())
        t2 = torch.nn.functional.linear(cn, p2.weight.float(),
                                        p2.bias.float())
        q1 = t1[..., :ch].reshape(b, h * w, heads, -1)
        k1 = t1[..., ch:2 * ch].reshape(b, h * w, heads, -1)
        q2 = t2[..., :ch].reshape(b, -1, heads, head_dim)
        k2 = t2[..., ch:2 * ch].reshape(b, -1, heads, head_dim)
        sx, sc = dca_scales(h * w, c_in.shape[1], ch)
        a_cx = torch.softmax(torch.einsum("bmhd,bnhd->bhmn", q2, k1) * sc,
                             -1)[0]
        a_xc = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q1, k2) * sx,
                             -1)[0]
    return a_cx, a_xc, (h, w)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from PIL import Image

    from lemevit_tpu_torch.data.transforms import (build_eval_transform,
                                                   normalize)
    from lemevit_tpu_torch.models.registry import (create_model,
                                                   resolve_device,
                                                   variant_config)
    from lemevit_tpu_torch.train.checkpoint import load_pretrained

    cfg = variant_config(args.model)
    if cfg["attn_type"][args.stage] not in ("D", "D2"):
        raise SystemExit(f"stage {args.stage} is "
                         f"{cfg['attn_type'][args.stage]!r}, pick a D stage")
    device = resolve_device(args.device)
    model = create_model(args.model, num_classes=1000, device=device).eval()
    if args.checkpoint:
        load_pretrained(model, args.checkpoint)
    img = Image.open(args.image).convert("RGB")
    x_u8 = build_eval_transform(args.img_size, crop_pct=1.0)(img)
    x = normalize(torch.from_numpy(np.array(x_u8))[None].to(device))
    a_cx, a_xc, (h, w) = attention_maps(model, x, args.stage, args.block,
                                        cfg["head_dim"])

    os.makedirs(args.out, exist_ok=True)
    base = np.asarray(x_u8, np.float32)

    def save_heat(heat2d, path):
        heat = np.asarray(heat2d)
        heat = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-9)
        heat = np.kron(heat, np.ones((args.img_size // h,
                                      args.img_size // w)))
        overlay = base.copy()
        overlay[..., 0] = np.clip(base[..., 0] * 0.4 + heat * 255 * 0.6,
                                  0, 255)
        Image.fromarray(overlay.astype(np.uint8)).save(path)

    amap = a_cx.mean(0).cpu().numpy()  # heads averaged: (M, N)
    m = amap.shape[0]
    paths = []
    for t in range(m):
        paths.append(os.path.join(args.out, f"meta_token_{t:02d}.png"))
        save_heat(amap[t].reshape(h, w), paths[-1])
    # where image tokens look among meta tokens: the entropy map
    mean_xc = a_xc.mean(0)
    ent = -(mean_xc * torch.log(mean_xc + 1e-9)).sum(-1)
    paths.append(os.path.join(args.out, "image_token_entropy.png"))
    save_heat(ent.cpu().numpy().reshape(h, w), paths[-1])
    print(f"wrote {m + 1} attention maps to {args.out}")
    return {"paths": paths, "grid": (h, w), "meta_tokens": m}


if __name__ == "__main__":
    main()
