"""Per-stage training-kernel microbenchmark: counterpart of
scripts/train_kbench.py.

For each lemevit_base stage shape (cli/kbench.py's STAGES, batch 256, bf16),
times the hand-written training block (``attn/fused_train.py``'s autograd
Functions, LN folded outside them as the model does) against the plain
autograd composition of the same block (``fused_block``'s plain forms), the
forward alone and forward + backward of scripts/train_kbench.py's loss
sum(out^2) * 1e-6, in ms per block. ``--cpe`` puts each block's 3x3 CPE
inside the training kernels (the model's ``train_cpe_in_kernel``), and
``--cpe-ext`` runs it as an ``F.conv2d`` under autograd before CPE-free
kernels (the default placement); without either there is no CPE, as in the
JAX script. The JAX script's ``--budgets`` (``PB_TRAIN_BWD_MB``) sweep is
TPU scoped-VMEM tuning and is not carried over.

  python -m lemevit_tpu_torch.cli.train_kbench [--stages 1,2,3,4]
      [--reps 20] [--impls kernel,plain] [--cpe | --cpe-ext]
  python -m lemevit_tpu_torch.cli.train_kbench --device cpu --batch-size 2

On the CPU only the plain compositions run, each row labelled "plain (cpu)".
"""
from __future__ import annotations

import argparse
import json

import torch

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales
from lemevit_tpu_torch.cli import kbench
from lemevit_tpu_torch.cli.kbench import B, M, STAGES


def fold(params, attn: str) -> tuple:
    """kbench's block parameters -> the LN-folded tuple of the training
    Functions (scripts/train_kbench.py::fused_params in torch layout): norm1
    into the attention's input projections, norm2 into fc1."""
    if attn == "S":
        (g1, b1n, wqkv, bqkv, wp, bp, g2, b2n, w1, b1, w2, b2) = params
        return (*ft.fold_ln(g1, b1n, wqkv, bqkv), wp, bp,
                *ft.fold_ln(g2, b2n, w1, b1), w2, b2)
    if attn == "C":
        (g1, b1n, wq, bq, wkv, bkv, wp, bp, g2, b2n, w1, b1, w2, b2) = params
        return (*ft.fold_ln(g1, b1n, wq, bq), *ft.fold_ln(g1, b1n, wkv, bkv),
                wp, bp, *ft.fold_ln(g2, b2n, w1, b1), w2, b2)
    (g1, b1n, wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc,
     g2, b2n, w1, b1, w2, b2) = params
    return (*ft.fold_ln(g1, b1n, wqkv1, bqkv1),
            *ft.fold_ln(g1, b1n, wqkv2, bqkv2), wpx, bpx, wpc, bpc,
            *ft.fold_ln(g2, b2n, w1, b1), w2, b2)


def loss_of(out) -> torch.Tensor:
    """scripts/train_kbench.py's loss: sum of squares * 1e-6, over both
    streams where the block returns two."""
    outs = out if isinstance(out, tuple) else (out,)
    return sum(o.float().square().sum() for o in outs) * 1e-6


def block_loss(impl: str, attn: str, x, c, params, *, heads: int,
               scale_x=None, scale_c=None, cpe=None, img_w: int = 0,
               cpe_in_kernel: bool = False) -> torch.Tensor:
    """The loss of one block on kbench's (unfolded) ``params``: the
    training Function ("kernel", DropPath scales one, the CPE inside it with
    ``cpe_in_kernel``, else ``fused_block.cpe_plain`` before it) or the
    plain composition ("plain"). Differentiable in x and params."""
    if impl == "plain":
        return loss_of(kbench.block("plain", attn, x, c, params, heads=heads,
                                    scale_x=scale_x, scale_c=scale_c,
                                    cpe=cpe, img_w=img_w))
    if cpe is not None and not cpe_in_kernel:
        x, cpe = fb.cpe_plain(x, *cpe, img_w), None
    dp = torch.ones(4, x.shape[0], dtype=torch.float32, device=x.device)
    kw = dict(num_heads=heads, cpe=cpe, img_w=img_w)
    if attn == "D":
        kw.update(scale_x=scale_x, scale_c=scale_c)
    fn = {"S": ft.s_block_train, "C": ft.c_block_train,
          "D": ft.dca_block_train}[attn]
    return loss_of(fn(x, c, fold(params, attn), dp, **kw))


def run_stage(st, impls, reps, device, *, batch=B, dtype=torch.bfloat16,
              cpe_mode=None) -> list:
    """Rows {stage, impl, fwd_ms, grad_ms, ...} of one stage; cpe_mode
    None, "in" (--cpe) or "ext" (--cpe-ext)."""
    x, c, params, cpe = kbench.stage_inputs(st, batch, dtype, device)
    x = (x.float() * 0.5).to(dtype)   # train_kbench.py's N(0, 1) * 0.5
    c = (c.float() * 0.5).to(dtype)
    n, ch = st["n"], st["c"]
    scale_x, scale_c = dca_scales(n, M, ch)
    kw = dict(heads=st["heads"], scale_x=scale_x, scale_c=scale_c,
              cpe=None if cpe_mode is None else cpe,
              img_w=int(round(n ** 0.5)), cpe_in_kernel=cpe_mode == "in")
    xg = x.detach().requires_grad_()
    pg = [p.detach().requires_grad_() for p in params]
    rows = []
    for impl in impls:
        def fwd():
            with torch.no_grad():
                return block_loss(impl, st["attn"], x, c, params, **kw)

        def grad():
            loss = block_loss(impl, st["attn"], xg, c, pg, **kw)
            return torch.autograd.grad(loss, [xg, *pg])
        rows.append({
            "stage": st["idx"], "attn": st["attn"], "n": n, "c": ch,
            "heads": st["heads"], "blocks": st["blocks"],
            "impl": impl if device.type == "cuda" else kbench.PLAIN_CPU,
            "cpe": cpe_mode or "none", "batch": batch,
            "fwd_ms": kbench.time_ms(fwd, reps, device),
            "grad_ms": kbench.time_ms(grad, reps, device)})
    return rows


def format_row(r: dict) -> str:
    """A row in the shape of scripts/train_kbench.py's lines."""
    return (f"stage{r['stage']} {r['attn']} N={r['n']} C={r['c']} "
            f"{r['impl']} (cpe {r['cpe']}): fwd {r['fwd_ms']:.3f} grad "
            f"{r['grad_ms']:.3f} ms/block (x{r['blocks']})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The JAX script's --budgets / PB_TRAIN_BWD_MB is TPU "
               "scoped-VMEM tuning and is not carried over.")
    p.add_argument("--stages", default="1,2,3,4")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--impls", default="kernel,plain",
                   help="comma-separated: kernel, plain")
    cpe = p.add_mutually_exclusive_group()
    cpe.add_argument("--cpe", action="store_true",
                     help="the 3x3 CPE inside the training kernels")
    cpe.add_argument("--cpe-ext", action="store_true",
                     help="the CPE as an F.conv2d before CPE-free kernels")
    p.add_argument("--batch-size", type=int, default=B)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (plain versions only)")
    return p


def main(argv=None) -> list:
    from lemevit_tpu_torch.models.registry import resolve_device
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    want = {int(s) for s in args.stages.split(",")}
    impls = args.impls.split(",") if device.type == "cuda" else ["plain"]
    cpe_mode = "in" if args.cpe else "ext" if args.cpe_ext else None
    rows = []
    for st in STAGES:
        if st["idx"] in want:
            new = run_stage(st, impls, args.reps, device,
                            batch=args.batch_size, cpe_mode=cpe_mode)
            for r in new:
                print(format_row(r), flush=True)
            rows += new
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
