"""Per-stage block-kernel microbenchmark: counterpart of scripts/kbench.py.

Times one LeMeBlock per stage shape of lemevit_base at 224^2 (batch 256, 16
meta tokens, bf16, inputs and weights from a seeded ``torch.Generator``),
the hand-written block kernel (``attn/fused_block.py``: c_block, dca_block,
s_block) against the plain PyTorch composition of the same block, in ms per
block and per stage. Every block carries its 3x3 CPE, as in the model: by
default an ``F.conv2d`` before the kernel, with ``--cpe-in-kernel`` inside it
(the blocks' ``cpe`` mode). ``--s-stage`` times stages 3-4 as one
``s_stage`` launch (each block's CPE inside) against the chain of
``s_block`` launches over the same blocks and CPEs, placed as
``--cpe-in-kernel`` says: what the model's ``s_stage`` switch changes.

  python -m lemevit_tpu_torch.cli.kbench [--stages 0,1,2,3,4] [--reps 50]
      [--impls kernel,plain] [--cpe-in-kernel] [--s-stage]
  python -m lemevit_tpu_torch.cli.kbench --device cpu --batch-size 2 --reps 1

On the CPU only the plain compositions run, each row labelled "plain (cpu)".
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from lemevit_tpu_torch.attn import fused_block as fb
from lemevit_tpu_torch.attn.reference import dca_scales
from lemevit_tpu_torch.utils.profiling import cuda_ms

# lemevit_base stage shapes at 224^2, head_dim 32 (scripts/kbench.py:26-33;
# attn C, D, D, S, S, dims 96 / 96 / 192 / 384 / 512, depths 2 / 4 / 4 / 18
# / 4)
STAGES = [
    dict(idx=0, attn="C", n=3136, c=96, heads=3, blocks=2),
    dict(idx=1, attn="D", n=3136, c=96, heads=3, blocks=4),
    dict(idx=2, attn="D", n=784, c=192, heads=6, blocks=4),
    dict(idx=3, attn="S", n=196, c=384, heads=12, blocks=18),
    dict(idx=4, attn="S", n=49, c=512, heads=16, blocks=4),
]
B = 256
M = 16
PLAIN_CPU = "plain (cpu)"


def make_params(g, ch, attn, dtype=torch.bfloat16, device="cpu"):
    """scripts/kbench.py::make_params in torch ``nn.Linear`` layout: the
    norms' scales one and biases zero, every other weight N(0, 1) * 0.02,
    the MLP 4C wide."""
    def r(*s):
        return (torch.randn(*s, generator=g) * 0.02).to(device, dtype)
    ones = torch.ones(ch, device=device, dtype=dtype)
    zeros = torch.zeros(ch, device=device, dtype=dtype)
    hidden = 4 * ch
    mlp = (ones, zeros, r(hidden, ch), r(hidden), r(ch, hidden), r(ch))
    if attn == "S":
        return (ones, zeros, r(3 * ch, ch), r(3 * ch), r(ch, ch), r(ch),
                *mlp)
    if attn == "C":
        return (ones, zeros, r(ch, ch), r(ch), r(2 * ch, ch), r(2 * ch),
                r(ch, ch), r(ch), *mlp)
    return (ones, zeros, r(3 * ch, ch), r(3 * ch), r(3 * ch, ch), r(3 * ch),
            r(ch, ch), r(ch), r(ch, ch), r(ch), *mlp)


def make_cpe(g, ch, dtype=torch.bfloat16, device="cpu"):
    """A block's 3x3 CPE: taps (9, C) N(0, 1) * 0.02, bias zero."""
    return ((torch.randn(9, ch, generator=g) * 0.02).to(device, dtype),
            torch.zeros(ch, device=device, dtype=dtype))


def block(impl: str, attn: str, x, c, params, *, heads: int, scale_x=None,
          scale_c=None, cpe=None, img_w: int = 0, cpe_in_kernel=False):
    """One pre-norm block: the kernel (impl "kernel") or the plain
    composition ("plain") of ``fused_block``. With ``cpe`` x is before the
    CPE, which runs inside the kernel with ``cpe_in_kernel`` and as
    ``fused_block.cpe_plain`` before it otherwise. The C block returns c,
    the D and S blocks (x, c); the scales are the D block's."""
    if cpe is not None and not (impl == "kernel" and cpe_in_kernel):
        x = fb.cpe_plain(x, *cpe, img_w)
        cpe = None
    kw = dict(num_heads=heads, cpe=cpe, img_w=img_w)
    if attn == "D":
        kw.update(scale_x=scale_x, scale_c=scale_c)
    name = {"S": "s_block", "C": "c_block", "D": "dca_block"}[attn]
    fn = getattr(fb, name if impl == "kernel" else name + "_plain")
    return fn(x, c, params, **kw)


def stage_inputs(st, batch, dtype, device, seed=0):
    """A stage's seeded x (B, N, C), c (B, M, C), block parameters and
    CPE."""
    g = torch.Generator().manual_seed(seed + st["idx"])
    n, ch = st["n"], st["c"]
    x = torch.randn(batch, n, ch, generator=g).to(device, dtype)
    c = torch.randn(batch, M, ch, generator=g).to(device, dtype)
    return x, c, make_params(g, ch, st["attn"], dtype, device), make_cpe(
        g, ch, dtype, device)


def time_ms(fn, reps: int, device) -> float:
    """Device ms per call on the card (CUDA events over ``reps`` warm
    calls); host ms per call on the CPU."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run_stage(st, impls, reps, device, *, batch=B, dtype=torch.bfloat16,
              cpe_in_kernel=False) -> list:
    """Rows {stage, impl, ms_block, ms_stage, ...} of one stage."""
    x, c, params, cpe = stage_inputs(st, batch, dtype, device)
    n, ch = st["n"], st["c"]
    scale_x, scale_c = dca_scales(n, M, ch)
    kw = dict(heads=st["heads"], scale_x=scale_x, scale_c=scale_c, cpe=cpe,
              img_w=int(round(n ** 0.5)), cpe_in_kernel=cpe_in_kernel)
    rows = []
    with torch.inference_mode():
        for impl in impls:
            ms = time_ms(lambda: block(impl, st["attn"], x, c, params, **kw),
                         reps, device)
            rows.append(_row(st, impl, device, ms, ms * st["blocks"],
                             batch=batch, cpe_in_kernel=cpe_in_kernel))
    return rows


def run_s_stage(st, impls, reps, device, *, batch=B, dtype=torch.bfloat16,
                cpe_in_kernel=False) -> list:
    """An S stage's blocks: one ``s_stage`` launch, the CPEs inside
    ("s_stage"), against the chain of ``s_block`` launches ("chain"), each
    block's CPE inside the kernel with ``cpe_in_kernel`` and an
    ``F.conv2d`` before it otherwise; on the CPU their plain versions."""
    g = torch.Generator().manual_seed(st["idx"])
    n, ch, nb = st["n"], st["c"], st["blocks"]
    x = torch.randn(batch, n, ch, generator=g).to(device, dtype)
    c = torch.randn(batch, M, ch, generator=g).to(device, dtype)
    plist = [make_params(g, ch, "S", dtype, device) for _ in range(nb)]
    cpes = [make_cpe(g, ch, dtype, device) for _ in range(nb)]
    kw = dict(num_heads=st["heads"], img_w=int(round(n ** 0.5)))
    kernel = "kernel" in impls and torch.device(device).type == "cuda"

    def staged():
        fn = fb.s_stage if kernel else fb.s_stage_plain
        return fn(x, c, plist, cpes=cpes, **kw)

    def chain():
        xx, cc = x, c
        for p, cp in zip(plist, cpes):
            xx, cc = block("kernel" if kernel else "plain", "S", xx, cc, p,
                           heads=st["heads"], cpe=cp, img_w=kw["img_w"],
                           cpe_in_kernel=cpe_in_kernel)
        return xx, cc

    rows = []
    with torch.inference_mode():
        for impl, fn in (("s_stage", staged), ("chain", chain)):
            ms = time_ms(fn, reps, device)
            rows.append(_row(st, "kernel" if kernel else "plain", device,
                             ms / nb, ms, batch=batch,
                             cpe_in_kernel=cpe_in_kernel, form=impl))
    return rows


def _row(st, impl, device, ms_block, ms_stage, **extra):
    return {"stage": st["idx"], "attn": st["attn"], "n": st["n"],
            "c": st["c"], "heads": st["heads"], "blocks": st["blocks"],
            "impl": impl if torch.device(device).type == "cuda"
            else PLAIN_CPU, "ms_block": ms_block, "ms_stage": ms_stage,
            **extra}


def format_row(r: dict) -> str:
    """A row as scripts/kbench.py prints it."""
    impl = r["impl"] + (f" {r['form']}" if "form" in r else "")
    return (f"stage{r['stage']} {r['attn']} N={r['n']} C={r['c']} "
            f"H={r['heads']} {impl:7s}: {r['ms_block']:7.3f} ms/block -> "
            f"{r['ms_stage']:7.2f} ms/stage")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", default="0,1,2,3,4")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--impls", default="kernel,plain",
                   help="comma-separated: kernel, plain")
    p.add_argument("--cpe-in-kernel", action="store_true",
                   help="the block kernels apply the 3x3 CPE (their cpe "
                        "mode) instead of an F.conv2d before them")
    p.add_argument("--s-stage", action="store_true",
                   help="stages 3-4: one s_stage launch against the chain "
                        "of s_block launches")
    p.add_argument("--batch-size", type=int, default=B)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (plain versions only)")
    return p


def main(argv=None) -> list:
    from lemevit_tpu_torch.models.registry import resolve_device
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    want = {int(s) for s in args.stages.split(",")}
    impls = args.impls.split(",")
    if device.type != "cuda":
        impls = ["plain"]
    rows = []
    for st in STAGES:
        if st["idx"] not in want:
            continue
        if args.s_stage:
            if st["attn"] != "S":
                continue
            new = run_s_stage(st, impls, args.reps, device,
                              batch=args.batch_size,
                              cpe_in_kernel=args.cpe_in_kernel)
        else:
            new = run_stage(st, impls, args.reps, device,
                            batch=args.batch_size,
                            cpe_in_kernel=args.cpe_in_kernel)
        for r in new:
            print(format_row(r), flush=True)
        rows += new
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
