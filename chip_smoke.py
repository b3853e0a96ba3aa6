"""Smoke run of lemevit_tpu_torch on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the CUDA kernels from lemevit_tpu_torch/attn/csrc and drives the
port's main paths, each with its kernels' launch counts set to 0 just before
it and read just after:
  - serving: every inference block kernel held against its plain PyTorch
    version at the shapes of LeMeViT-Base at 224^2, base's kernel path
    against its plain path, a bf16 batch of 64 served through
    cli.benchmark's inference function, and cli.validate on synthetic data;
  - training vit_tiny (all S blocks): the three S-block training kernels
    and the S inference kernel held against their plain versions at
    vit_tiny's shapes, one fp32 train step on the kernel path against the
    plain path, then cli.train on synthetic data (224^2, bf16, batch 64,
    configs/lemevit.yaml, 6 steps and one eval) and a profile of one train
    step;
  - training lemevit_tiny (C, D and S blocks): the inference kernels at its
    five shapes, its C, D and S training kernels (forward, MLP backward,
    attention backward) held against their plain versions, a D2 training
    block through the weight permutation, one fp32 train step on the kernel
    path against the plain path, cli.train as above, cli.benchmark --bench
    train, and a profile of one train step.
Every phase prints one line; any failure raises and exits non-zero. The
last lines are a JSON object of per-kernel numbers, the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

B_CHECK = 8          # batch of the fp32 kernel checks
B_MAIN = 64          # batch of the served and trained main paths (bf16)
M = 16               # meta tokens of every released variant
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
TRAIN_STEPS = 6             # steps of each cli.train run
REPO = Path(__file__).resolve().parent

# Base at 224^2: (kernel, N, C, launches per forward)
MAIN_SHAPES = [("c_block", 3136, 96, 2),
               ("dca_block", 3136, 96, 4), ("dca_block", 784, 192, 4),
               ("s_block", 196, 384, 18), ("s_block", 49, 512, 4)]
# lemevit_tiny at 224^2: (kernel, N, C, launches per eval forward)
TINY_SHAPES = [("c_block", 3136, 64, 1),
               ("dca_block", 3136, 64, 2), ("dca_block", 784, 128, 2),
               ("s_block", 196, 192, 8), ("s_block", 49, 320, 2)]
# its training blocks: (kind, N, C, blocks); each block launches its
# forward, mlp_bwd and attention backward once per train step
TINY_TRAIN = [("c", 3136, 64, 1), ("dca", 3136, 64, 2), ("dca", 784, 128, 2),
              ("s", 196, 192, 8), ("s", 49, 320, 2)]
# vit_tiny at 224^2, stages 1-3 (stage 0, N = 3136, composes as in the JAX
# package): S blocks, each launching s_block once per eval forward
VIT_TRAIN = [("s", 784, 192, 2), ("s", 196, 320, 4), ("s", 49, 384, 2)]
TRAIN_PHASES = {"s": ("s_train_fwd", "mlp_bwd", "s_attn_bwd"),
                "dca": ("dca_train_fwd", "mlp_bwd", "dca_attn_bwd"),
                "c": ("c_train_fwd", "mlp_bwd", "c_attn_bwd")}
KERNELS = {
    "c_block": ("lemevit_tpu_torch/attn/csrc/c_block.cu",
                "lemevit_tpu/attn/pallas_block.py:1069"),
    "dca_block": ("lemevit_tpu_torch/attn/csrc/dca_block.cu",
                  "lemevit_tpu/attn/pallas_block.py:929"),
    "s_block": ("lemevit_tpu_torch/attn/csrc/s_block.cu",
                "lemevit_tpu/attn/pallas_block.py:1095"),
    "s_train_fwd": ("lemevit_tpu_torch/attn/csrc/s_train.cu",
                    "lemevit_tpu/attn/pallas_train.py:907"),
    "mlp_bwd": ("lemevit_tpu_torch/attn/csrc/s_train.cu",
                "lemevit_tpu/attn/pallas_train.py:559"),
    "s_attn_bwd": ("lemevit_tpu_torch/attn/csrc/s_train.cu",
                   "lemevit_tpu/attn/pallas_train.py:971"),
    "dca_train_fwd": ("lemevit_tpu_torch/attn/csrc/dca_train.cu",
                      "lemevit_tpu/attn/pallas_train.py:1095"),
    "dca_attn_bwd": ("lemevit_tpu_torch/attn/csrc/dca_train.cu",
                     "lemevit_tpu/attn/pallas_train.py:1156"),
    "c_train_fwd": ("lemevit_tpu_torch/attn/csrc/c_train.cu",
                    "lemevit_tpu/attn/pallas_train.py:1442"),
    "c_attn_bwd": ("lemevit_tpu_torch/attn/csrc/c_train.cu",
                   "lemevit_tpu/attn/pallas_train.py:1514"),
}
# launches per train step and per eval forward of each trained model
VIT_STEP = {"s_train_fwd": 8, "mlp_bwd": 8, "s_attn_bwd": 8}
VIT_EVAL = {"s_block": 8}
TINY_STEP = {"c_train_fwd": 1, "c_attn_bwd": 1, "dca_train_fwd": 4,
             "dca_attn_bwd": 4, "s_train_fwd": 10, "s_attn_bwd": 10,
             "mlp_bwd": 15}
TINY_EVAL = {"c_block": 1, "dca_block": 4, "s_block": 10}
# tolerances of the training-kernel checks: outputs |err| <= tol (1 + |ref|),
# gradients |err| <= tol (max|ref| + |ref|) per tensor (a weight gradient
# sums B N products, so its error scales with the tensor, not the element)
TRAIN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() over iters back-to-back calls (CUDA
    events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms, what bounds it) on the H100 SXM data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def reset(*counts) -> None:
    for c in counts:
        for k in c:
            c[k] = 0


def make_params(kind, ch, hidden, g):
    """Seeded O(1)-scale parameters of one block, torch Linear layout."""
    def lin(o, i):
        return [torch.randn(o, i, generator=g) * i ** -0.5,
                torch.randn(o, generator=g) * 0.1]

    def ln():
        return [1 + 0.1 * torch.randn(ch, generator=g),
                0.1 * torch.randn(ch, generator=g)]
    if kind == "c_block":
        p = ln() + lin(ch, ch) + lin(2 * ch, ch) + lin(ch, ch)
    elif kind == "dca_block":
        p = ln() + lin(3 * ch, ch) + lin(3 * ch, ch) + lin(ch, ch) + lin(ch, ch)
    else:
        p = ln() + lin(3 * ch, ch) + lin(ch, ch)
    return p + ln() + lin(hidden, ch) + lin(ch, hidden)


def work(kind, b, n, ch, hidden, n_params_bytes, elt):
    """(bytes, operations) one call must move and do: each input read
    once, each output written once; multiply-adds counted as two."""
    m = M
    if kind == "c_block":
        io = (b * n * ch + 2 * b * m * ch) * elt
        flops = 2 * b * (m * ch * ch + n * ch * 2 * ch + 2 * m * n * ch
                         + m * ch * ch + 2 * m * ch * hidden)
    elif kind == "dca_block":
        io = (2 * b * n * ch + 2 * b * m * ch) * elt
        rows = n + m
        flops = 2 * b * (rows * ch * 3 * ch + 4 * n * m * ch
                         + rows * ch * ch + 2 * rows * ch * hidden)
    else:
        io = (2 * b * n * ch + 2 * b * m * ch) * elt
        rows = n + m
        flops = 2 * b * (rows * ch * 3 * ch + 2 * (n * n + m * m) * ch
                         + rows * ch * ch + 2 * rows * ch * hidden)
    return io + n_params_bytes, flops


def train_work(phase, b, n, ch, elt=2):
    """(bytes, operations) of one training-kernel call at hidden = 4C:
    each input read once, each output written once (fp32 log-sum-exp rows
    and DropPath scales at 4 bytes); the operations include what the
    call's interface makes it recompute (qkv, q / kv, fc1). n is the image
    tokens the call sees (0 for the C block's meta-only MLP backward)."""
    rx, rc = b * n, b * M
    rows = rx + rc
    act = lambda r: r * ch * elt
    lse = lambda r: 4 * (ch // 32) * r
    dp = 4 * 4 * b
    w_mlp = 8 * ch * ch + 5 * ch
    if phase == "mlp_bwd":       # t1, dout -> dt1, dW1, db1, dW2, db2
        return 3 * act(rows) + 2 * w_mlp * elt + dp, 40 * rows * ch * ch
    kind, fwd = phase.split("_")[0], phase.endswith("_fwd")
    if kind == "c":              # q from the meta rows, kv from the image rows
        w = 4 * ch * ch + 4 * ch
        if fwd:                  # x, c -> c_out, t1c, o (+ lse)
            return (act(rx) + 4 * act(rc) + (w + w_mlp) * elt + lse(rc) + dp,
                    4 * rx * ch * ch + 20 * rc * ch * ch + 4 * b * M * n * ch)
        # x, c, dt1c, o, lse -> dxt, dc, dWq, dbq, dWkv, dbkv, dWp
        return (2 * act(rx) + 4 * act(rc) + 2 * w * elt + lse(rc) + dp,
                12 * rx * ch * ch + 10 * rc * ch * ch + 10 * b * M * n * ch)
    if kind == "s":              # both streams attend to themselves
        w, pairs = 4 * ch * ch + 4 * ch, b * (n * n + M * M)
    else:                        # each stream attends to the other
        w, pairs = 8 * ch * ch + 8 * ch, 2 * b * n * M
    if fwd:                      # x, c -> out, t1, o (+ lse)
        return (4 * act(rows) + (w + w_mlp) * elt + lse(rows) + dp,
                24 * rows * ch * ch + 4 * pairs * ch)
    # x, dt1, o, lse -> dx, the attention's weight gradients
    return (4 * act(rows) + 2 * w * elt + lse(rows) + dp,
            22 * rows * ch * ch + 10 * pairs * ch)


def max_err(got, want, tol):
    """Max abs error; raises where |err| > tol (1 + |ref|) or a value is
    not finite."""
    err = 0.0
    for a, r in zip(got, want):
        a = a.float()
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        d = (a - r).abs()
        bad = int((d > tol + tol * r.abs()).sum())
        if bad:
            raise AssertionError(f"{bad} elements beyond tol {tol}, "
                                 f"max abs err {d.max().item():.3g}")
        err = max(err, d.max().item())
    return err


def max_grad_err(got, want, tol, names):
    """Max abs error over gradient tensors; raises where |err| > tol
    (max|ref| + |ref|) within a tensor."""
    err = 0.0
    for a, r, name in zip(got, want, names):
        a = a.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"gradient {name} is not finite")
        d = (a - r).abs()
        lim = tol * (r.abs().max() + r.abs())
        if bool((d > lim).any()):
            raise AssertionError(f"gradient {name}: max abs err "
                                 f"{d.max().item():.3g} beyond tol {tol} "
                                 f"of max |ref| {r.abs().max().item():.3g}")
        err = max(err, d.max().item())
    return err


def profile_call(fn, what: str, top: int = 16) -> dict:
    """Device time of one fn() by CUDA kernel name (torch.profiler), and
    the device's busy share of its wall time. Runs after a main path's
    launch counts are read, so it adds no counted launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only; a user annotation's range on the device (the
    # optimizer's step) spans kernels counted already
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        say("profile", f"{what}: no device time recorded: not measured")
        return {}
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "lm::" in r[0])
    launches = sum(r[2] for r in rows)
    say("profile", f"{what}: {wall_ms:.2f} ms wall (profiled), {busy:.2f} "
        f"ms of device kernels ({100 * busy / wall_ms:.1f}% busy) in "
        f"{launches} launches, of which {ours:.2f} ms "
        f"({100 * ours / busy:.1f}%) in the port's kernels (lm::) and "
        f"{busy - ours:.2f} ms in PyTorch's")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        say("profile", f"{ms:8.3f} ms  {count:4d}x  {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy, "port_ms": ours,
            "launches": launches}


def check_block_kernel(fb, kind, n, ch, per_fwd, dev, g):
    """One inference block kernel at one shape: fp32 at B_CHECK (rtol =
    atol = 1e-4), bf16 at B_MAIN (3e-2 against fp32 on the same bf16-cast
    inputs), then times, bound and rate at B_MAIN in bf16."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    wrappers = {"c_block": fb.c_block, "dca_block": fb.dca_block,
                "s_block": fb.s_block}
    plains = {"c_block": fb.c_block_plain, "dca_block": fb.dca_block_plain,
              "s_block": fb.s_block_plain}

    def call(fns, x, c, p):
        kw = {"num_heads": ch // 32}
        if kind == "dca_block":
            kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
        out = fns[kind](x, c, p, **kw)
        return out if isinstance(out, tuple) else (out,)

    hidden = 4 * ch
    p32 = make_params(kind, ch, hidden, g)
    x = torch.randn(B_MAIN, n, ch, generator=g)
    c = torch.randn(B_MAIN, M, ch, generator=g)
    xs, cs = x[:B_CHECK].to(dev), c[:B_CHECK].to(dev)
    ps = [t.to(dev) for t in p32]
    err32 = max_err(call(wrappers, xs, cs, ps), call(plains, xs, cs, ps),
                    1e-4)
    xb, cb = x.to(dev, torch.bfloat16), c.to(dev, torch.bfloat16)
    pb = [t.to(dev, torch.bfloat16) for t in p32]
    got = call(wrappers, xb, cb, pb)
    want = call(plains, xb.float(), cb.float(), [t.float() for t in pb])
    err16 = max_err(got, want, 3e-2)
    del got, want
    ms = cuda_ms(lambda: call(wrappers, xb, cb, pb))
    plain_ms = cuda_ms(lambda: call(plains, xb, cb, pb))
    nbytes, flops = work(kind, B_MAIN, n, ch, hidden,
                         sum(t.numel() for t in pb) * 2, 2)
    t_bound, by = bound(nbytes, flops)
    row = dict(name=kind, n=n, c=ch, batch=B_MAIN, per_forward=per_fwd,
               err_fp32=err32, err_bf16=err16, ms=ms, plain_ms=plain_ms,
               bound_ms=t_bound, bound_by=by, tflops=flops / ms / 1e9)
    say("kernel", f"{kind} N={n} C={ch}: fp32 err {err32:.2e} (B=8), "
        f"bf16 err {err16:.2e} (B=64); {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms; bound {t_bound:.4f} ms ({by}); "
        f"{row['tflops']:.1f} TFLOP/s")
    return row


def train_inputs(ft, kind, b, n, ch, g, dev, dtype):
    """x, c, the LN-folded parameter tuple of an "s", "dca" or "c" block,
    DropPath scales (keep 0.85) and upstream gradients, seeded, in
    ``dtype`` on ``dev``."""
    params = []
    for shape in ft._param_shapes(kind, ch, 4 * ch):
        params.append(torch.randn(shape, generator=g) * shape[-1] ** -0.5
                      if len(shape) == 2 else
                      torch.randn(shape, generator=g) * 0.1)
    x = torch.randn(b, n, ch, generator=g)
    c = torch.randn(b, M, ch, generator=g)
    dp = (torch.rand(4, b, generator=g) < 0.85).float() / 0.85
    gx = torch.randn(b, n, ch, generator=g)
    gc = torch.randn(b, M, ch, generator=g)
    cast = [t.to(dev, dtype) for t in (x, c, gx, gc, *params)]
    return cast[0], cast[1], cast[4:], dp.to(dev), cast[2], cast[3]


def run_train_block(fn, x, c, params, dp, gx, gc, kw):
    """Outputs and the gradients of x, c and every parameter of fn under
    upstream grads gx, gc (the C block's one output takes gc)."""
    ts = [t.detach().clone().requires_grad_() for t in (x, c, *params)]
    out = fn(ts[0], ts[1], ts[2:], dp, **kw)
    out = out if isinstance(out, tuple) else (out,)
    ups = [gx, gc] if len(out) == 2 else [gc]
    torch.autograd.backward(list(out), [u.to(o.dtype)
                                        for u, o in zip(ups, out)])
    return [o.float() for o in out], [t.grad.float() for t in ts]


def phase_calls(ft, kind, x, c, p, dp, gx, gc, kw):
    """{phase: (kernel call, plain call)} of one training block, each
    phase on the outputs of the one before (the C block's MLP backward on
    an empty image stream)."""
    w1, b1, w2 = p[-4], p[-3], p[-2]
    name = TRAIN_PHASES[kind]
    fwd = getattr(ft, name[0])(x, c, p, dp, **kw)
    if kind == "c":
        none = x[:, :0]
        mlp_args = (none, fwd[1], none, gc, dp, w1, b1, w2)
        mlp = ft.mlp_bwd(*mlp_args)
        wq, bq, wkv, bkv, wp = p[:5]
        attn_args = (x, c, mlp[1], dp, wq, bq, wkv, bkv, wp, fwd[2], fwd[3])
    else:
        mlp_args = (fwd[2], fwd[3], gx, gc, dp, w1, b1, w2)
        mlp = ft.mlp_bwd(*mlp_args)
        attn_w = p[:3] if kind == "s" else p[:5] + p[6:7]
        attn_args = (x, c, mlp[0], mlp[1], dp, *attn_w, *fwd[4:])
    return {
        name[0]: (lambda: getattr(ft, name[0])(x, c, p, dp, **kw),
                  lambda: getattr(ft, name[0] + "_plain")(x, c, p, dp, **kw)),
        "mlp_bwd": (lambda: ft.mlp_bwd(*mlp_args),
                    lambda: ft.mlp_bwd_plain(*mlp_args)),
        name[2]: (lambda: getattr(ft, name[2])(*attn_args, **kw),
                  lambda: getattr(ft, name[2] + "_plain")(*attn_args, **kw)),
    }


def check_train_kernels(ft, kind, n, ch, blocks, dev, g, profile=False):
    """A training block (its three kernels under autograd) against its
    autograd composition: fp32 at B_CHECK, bf16 at B_MAIN against fp32 on
    the same bf16-cast inputs (TRAIN_TOL); then each kernel timed at
    B_MAIN in bf16 beside its plain phase and its bound. The last four
    gradients (fc1, fc2) come from the MLP backward, the rest from the
    attention backward (which also carries the MLP's dt1 into dx / dc).
    With ``profile``, the attention backward's device time by kernel."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    kw = {"num_heads": ch // 32}
    if kind == "dca":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
    fused = getattr(ft, f"{kind}_block_train")
    plain = getattr(ft, f"{kind}_block_train_plain")
    fwd_name, _, bwd_name = TRAIN_PHASES[kind]
    errs = {}
    for dtype, b in ((torch.float32, B_CHECK), (torch.bfloat16, B_MAIN)):
        x, c, p, dp, gx, gc = train_inputs(ft, kind, b, n, ch, g, dev, dtype)
        got_o, got_g = run_train_block(fused, x, c, p, dp, gx, gc, kw)
        torch.cuda.synchronize()
        want_o, want_g = run_train_block(
            plain, x.float(), c.float(), [t.float() for t in p], dp,
            gx.float(), gc.float(), kw)
        otol, gtol = TRAIN_TOL[dtype]
        names = [f"grad {i}" for i in range(len(want_g))]
        errs[dtype] = {
            fwd_name: max_err(got_o, want_o, otol),
            "mlp_bwd": max_grad_err(got_g[-4:], want_g[-4:], gtol,
                                    names[-4:]),
            bwd_name: max_grad_err(got_g[:-4], want_g[:-4], gtol,
                                   names[:-4]),
            "scale": max(w.abs().max().item() for w in want_g)}
        del got_o, got_g, want_o, want_g
    # times per kernel, bf16, B_MAIN, on the inputs of the last check
    rows = []
    for name, (kern, plain_fn) in phase_calls(ft, kind, x, c, p, dp, gx, gc,
                                              kw).items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain_fn)
        n_seen = 0 if (kind == "c" and name == "mlp_bwd") else n
        t_bound, by = bound(*train_work(name, B_MAIN, n_seen, ch))
        if profile and name == bwd_name:
            profile_call(kern, f"{name} N={n} C={ch} B={B_MAIN}", top=10)
        rows.append(dict(
            name=name, kind=kind, n=n, c=ch, batch=B_MAIN, per_step=blocks,
            err_fp32=errs[torch.float32][name],
            err_bf16=errs[torch.bfloat16][name],
            grad_scale_bf16=errs[torch.bfloat16]["scale"], ms=ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by))
    e32, e16 = errs[torch.float32], errs[torch.bfloat16]
    say("train-kernel", f"{kind} N={n} C={ch}: fp32 B=8 err out "
        f"{e32[fwd_name]:.2e}, grads {max(e32['mlp_bwd'], e32[bwd_name]):.2e}"
        f" of max {e32['scale']:.3g}; bf16 B=64 err out {e16[fwd_name]:.2e}, "
        f"grads {max(e16['mlp_bwd'], e16[bwd_name]):.2e} of max "
        f"{e16['scale']:.3g} | " + "; ".join(
            f"{r['name']} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"bound {r['bound_ms']:.4f} {r['bound_by']})" for r in rows))
    return rows


def check_d2_train_block(ft, dev, g):
    """A train-mode D2 block (lemevit_tiny_v2's stage 1: N = 3136, C = 96)
    through the D training kernels by the weight permutation, against its
    own composition with the same DropPath scales: outputs 1e-4, the
    gradients of x, c and every parameter 1e-3 of their largest element."""
    from lemevit_tpu_torch.models.lemevit import LeMeBlock
    blk = LeMeBlock(96, 3, "D2", drop_path=0.15).to(dev).train()
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g).to(dev) * 0.3)
    x = torch.randn(B_CHECK, 56, 56, 96, generator=g).to(dev)
    c = torch.randn(B_CHECK, M, 96, generator=g).to(dev)
    dp = (torch.rand(4, B_CHECK, generator=g) < 0.85).float().to(dev) / 0.85
    runs = []
    before = dict(ft.LAUNCHES)
    for backend in ("cuda", "torch"):
        blk.attn_backend = backend
        blk.zero_grad(set_to_none=True)
        xs, cs = x.clone().requires_grad_(), c.clone().requires_grad_()
        xo, co = blk(xs, cs, dp)
        (xo.square().mean() + co.square().mean()).backward()
        runs.append(([xo.detach(), co.detach()],
                     [xs.grad, cs.grad] + [q.grad for q in blk.parameters()]))
        if backend == "cuda":
            launched = {k: ft.LAUNCHES[k] - before[k] for k in before
                        if ft.LAUNCHES[k] != before[k]}
    if launched != {"dca_train_fwd": 1, "mlp_bwd": 1, "dca_attn_bwd": 1}:
        raise AssertionError(f"D2 train block launches {launched}")
    e_out = max_err(runs[0][0], runs[1][0], 1e-4)
    names = ["x", "c"] + [n for n, _ in blk.named_parameters()]
    e_grad = 0.0
    for a, b, name in zip(runs[0][1], runs[1][1], names):
        d = (a - b).abs().max().item()
        if not d <= 1e-3 * b.abs().max().item() + 1e-6:
            raise AssertionError(f"D2 gradient {name}: {d:.3g}")
        e_grad = max(e_grad, d / (b.abs().max().item() + 1e-12))
    say("train-kernel", f"D2 permutation N=3136 C=96 fp32 B=8: out err "
        f"{e_out:.2e}; gradients within {e_grad:.2e} of their largest "
        f"element (limit 1e-3); launches {launched}")


def check_train_step(ft, dev, name, expect):
    """One fp32 train step's loss and gradients of ``name`` at 224^2, B=2,
    drop-path 0.15 with the same masks: the kernel path against
    --attn-backend torch. Limits: loss 1e-4 abs; each parameter's gradient
    max |err| <= 1e-3 max|ref| + 1e-6."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.steps import cross_entropy_loss
    kern = create_model(name, device=dev, drop_path_rate=0.15).train()
    plain = copy.deepcopy(kern)
    plain.set_attn_backend("torch")
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (2,), generator=g).to(dev)
    before = dict(ft.LAUNCHES)
    losses = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device=dev).manual_seed(11))
        loss = cross_entropy_loss(m(img), labels)
        loss.backward()
        losses.append(loss.item())
    launched = {k: ft.LAUNCHES[k] - before[k] for k in before
                if ft.LAUNCHES[k] != before[k]}
    if launched != expect:
        raise AssertionError(f"{name} train step launches {launched}, "
                             f"expected {expect}")
    if not abs(losses[0] - losses[1]) <= 1e-4:
        raise AssertionError(f"{name} train-step loss {losses[0]} vs plain "
                             f"{losses[1]}")
    worst = 0.0  # the largest error as a share of its limit
    for (pname, a), b in zip(kern.named_parameters(), plain.parameters()):
        d = (a.grad - b.grad).abs().max().item()
        scale = b.grad.abs().max().item()
        if not d <= 1e-3 * scale + 1e-6:
            raise AssertionError(f"gradient of {pname}: max abs err {d:.3g} "
                                 f"of max {scale:.3g}")
        worst = max(worst, d / (1e-3 * scale + 1e-6))
    say("train-step", f"{name} 224 fp32 B=2: loss {losses[0]:.6f} vs plain "
        f"{losses[1]:.6f} (|diff| {abs(losses[0] - losses[1]):.2e}, limit "
        f"1e-4); gradients within {100 * worst:.1f}% of their limits "
        f"(1e-3 max|ref| + 1e-6); launches {launched}")


def train_main_path(ft, fb, model, per_step, per_eval):
    """cli.train on synthetic data: ``model``, 224^2, bf16, B=64, the
    reference recipe (configs/lemevit.yaml: mixup, cutmix, erasing,
    smoothing, drop-path 0.15, EMA), 1 epoch of TRAIN_STEPS steps and one
    eval of the live and EMA models, its launch counts set to 0 just before
    and read just after. Returns (launches, result)."""
    from lemevit_tpu_torch.cli import train as train_cli
    with tempfile.TemporaryDirectory() as out:
        reset(ft.LAUNCHES, fb.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        res = train_cli.main([
            "--synthetic", "--model", model, "--img-size", "224",
            "--batch-size", str(B_MAIN),
            "--config", str(REPO / "configs" / "lemevit.yaml"),
            "--epochs", "1", "--steps-per-epoch", str(TRAIN_STEPS),
            "--output", out])
        launches = {**ft.LAUNCHES, **fb.LAUNCHES}
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(Path(out) / model / "summary.csv") as f:
            rows = list(csv.DictReader(f))
        if list(rows[0]) != train_cli.SUMMARY_FIELDS or len(rows) != 1:
            raise AssertionError(f"summary.csv: {rows}")
        ckpts = list((Path(out) / model / "checkpoints").glob(
            "checkpoint-*.pth"))
    eval_fwds = 2 * 2  # two val batches, live and EMA model
    want = {k: 0 for k in launches}
    want.update({k: v * TRAIN_STEPS for k, v in per_step.items()})
    want.update({k: v * eval_fwds for k, v in per_eval.items()})
    if launches != want:
        raise AssertionError(f"{model}: launches {launches} in "
                             f"{TRAIN_STEPS} steps and {eval_fwds} eval "
                             f"forwards, expected {want}")
    loss = res["train_loss"]
    if not (loss == loss and abs(loss) < 1e3) or res["steps"] != TRAIN_STEPS \
            or len(ckpts) != 1:
        raise AssertionError(f"train: {res}, checkpoints {ckpts}")
    say("train", f"{model} 224 bf16 B={B_MAIN}: {res['steps']} steps, "
        f"loss {loss:.4f}, {res['samples_per_sec']:.2f} img/s, "
        f"{res['step_ms']:.2f} ms/step (steps 2-{TRAIN_STEPS}), peak "
        f"{res['peak_gib']:.2f} GiB allocated; eval top1 "
        f"{res['best_top1']:.3f}; launches per step " + ", ".join(
            f"{k} {launches[k] // TRAIN_STEPS}" for k in per_step)
        + "; per eval forward " + ", ".join(
            f"{k} {launches[k] // eval_fwds}" for k in per_eval))
    return launches, res


def profile_train_step(dev, name):
    """torch.profiler table of one bf16 B=64 train step of ``name``."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from lemevit_tpu_torch.train.state import ModelEma, TrainState
    from lemevit_tpu_torch.train.steps import train_step
    model = create_model(name, device=dev, drop_path_rate=0.15)
    model.set_generator(torch.Generator(device=dev).manual_seed(0))
    state = TrainState(model, build_optimizer(model), build_lr_schedule(),
                       ModelEma(model, 0.996))
    g = torch.Generator().manual_seed(5)
    img = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (B_MAIN,), generator=g).to(dev)
    return profile_call(lambda: train_step(state, img, labels,
                                           autocast_dtype=torch.bfloat16),
                        f"one {name} train step")


def host_batch_ms(n: int = 3) -> float:
    """Host time to build one synthetic training batch (B_MAIN images at
    224^2, as cli.train's loader thread builds them), mean of n."""
    from lemevit_tpu_torch.data.datasets import SyntheticDataset
    from lemevit_tpu_torch.data.loader import _collate
    ds = SyntheticDataset(num_samples=n * B_MAIN, image_size=224)
    t0 = time.perf_counter()
    for i in range(n):
        _collate(ds, range(i * B_MAIN, (i + 1) * B_MAIN))
    return (time.perf_counter() - t0) / n * 1e3


def kernel_entry(name, rows, launches, weight_key, **extra):
    """The per-kernel JSON entry: launch-weighted means over the main
    path's shapes."""
    src, replaces = KERNELS[name]
    w = sum(r[weight_key] for r in rows)

    def mean(key):
        return sum(r[key] * r[weight_key] for r in rows) / w
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["err_bf16"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": max(rows, key=lambda r: r["bound_ms"]
                        * r[weight_key])["bound_by"],
        "library_ms": None, "shapes": strip(rows), **extra}


def strip(rows):
    """Shape rows without their kernel name, for the JSON line."""
    return [{k: v for k, v in r.items() if k != "name"} for r in rows]


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        sys.exit(1)
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.attn import _build
    from lemevit_tpu_torch.attn import fused_block as fb
    from lemevit_tpu_torch.attn import fused_train as ft
    from lemevit_tpu_torch.cli import benchmark, validate
    from lemevit_tpu_torch.models.lemevit import LeMeBlock

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind_name = torch.cuda.get_device_name(0)
    say("card", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind_name} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.time()
    lib_path = _build.build()
    _build.library()
    say("build", f"{lib_path.name} in {time.time() - t0:.1f} s")

    # 3. inference kernels against their plain versions
    g = torch.Generator().manual_seed(0)
    shape_rows = [check_block_kernel(fb, kind, n, ch, per_fwd, dev, g)
                  for kind, n, ch, per_fwd in MAIN_SHAPES]

    # D2 reaches the D kernel through the weight permutation
    blk = LeMeBlock(96, 3, "D2").to(dev).eval()
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g).to(dev) * 0.3)
        xd = torch.randn(B_CHECK, 56, 56, 96, generator=g).to(dev)
        cd = torch.randn(B_CHECK, M, 96, generator=g).to(dev)
        blk.attn_backend = "cuda"
        got = blk(xd, cd)
        blk.attn_backend = "torch"
        want = blk(xd, cd)
    say("kernel", f"dca_block D2 permutation N=3136 C=96: fp32 err "
        f"{max_err(got, want, 1e-4):.2e}")

    # 4. the model: kernel path against plain path (fp32, B=2)
    model = create_model("lemevit_base", device=dev).eval()
    img = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    with torch.no_grad():
        fused = model(img)
        model.set_attn_backend("torch")
        plain = model(img)
    err = (fused - plain).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"base logits: kernel vs plain path {err:.3g}")
    say("model", f"lemevit_base 224 fp32 B=2: kernel vs plain logits max "
        f"abs err {err:.2e} (limit 1e-3)")
    del model

    # the serving main path: bf16 B=64 through cli.benchmark's inference
    args = benchmark.build_parser().parse_args(
        ["--model", "lemevit_base", "--batch-size", str(B_MAIN),
         "--num-warm-iter", "2", "--num-bench-iter", "10"])
    model = create_model("lemevit_base", device=dev,
                         dtype=torch.bfloat16).eval()
    x = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    reset(fb.LAUNCHES)
    res, logits = benchmark.run_inference(args, model, x)
    launches = dict(fb.LAUNCHES)
    n_fwd = args.num_warm_iter + args.num_bench_iter
    expect = {"c_block": 2, "dca_block": 8, "s_block": 22}
    for k, per in expect.items():
        if launches[k] != per * n_fwd:
            raise AssertionError(f"{k}: {launches[k]} launches in {n_fwd} "
                                 f"forwards, expected {per} per forward")
    if logits.shape != (B_MAIN, 1000) or not torch.isfinite(logits).all():
        raise AssertionError("main-path logits are not finite (64, 1000)")
    say("serve", f"lemevit_base 224 bf16 B={B_MAIN}: "
        f"{res['samples_per_sec']} img/s, {res['step_time']} ms/step; "
        f"launches per forward " + ", ".join(
            f"{k} {launches[k] // n_fwd}" for k in expect))
    with torch.inference_mode():
        profile_call(lambda: model(x), "one forward")
    del model

    # 5. validate on synthetic data
    vres = validate.main(["--model", "lemevit_base", "--synthetic",
                          "--batch-size", str(B_MAIN), "--max-batches", "2"])
    if not (vres["loss"] > 0 and vres["samples_per_sec"] > 0):
        raise AssertionError(f"validate: {vres}")
    say("validate", json.dumps(vres))

    # 6. training vit_tiny (all S): the inference and training kernels at
    #    its shapes, one step against the plain path, then its main path and
    #    a profile of one train step
    vit_eval_rows = [check_block_kernel(fb, "s_block", n, ch, blocks, dev, g)
                     for _, n, ch, blocks in VIT_TRAIN]
    vit_rows = []
    for kind, n, ch, blocks in VIT_TRAIN:
        vit_rows += check_train_kernels(ft, kind, n, ch, blocks, dev, g)
    check_train_step(ft, dev, "vit_tiny", VIT_STEP)
    vit_launches, _ = train_main_path(ft, fb, "vit_tiny", VIT_STEP, VIT_EVAL)
    profile_train_step(dev, "vit_tiny")

    # 7. training lemevit_tiny (C, D, S): inference kernels at its shapes,
    #    its training kernels, a D2 block, one step against the plain path,
    #    then its main path, cli.benchmark --bench train and a profile
    tiny_rows = [check_block_kernel(fb, kind, n, ch, per_fwd, dev, g)
                 for kind, n, ch, per_fwd in TINY_SHAPES]
    train_rows = []
    for kind, n, ch, blocks in TINY_TRAIN:
        train_rows += check_train_kernels(ft, kind, n, ch, blocks, dev, g,
                                          profile=n == 3136)
    check_d2_train_block(ft, dev, g)
    check_train_step(ft, dev, "lemevit_tiny", TINY_STEP)
    tiny_launches, tiny_res = train_main_path(ft, fb, "lemevit_tiny",
                                              TINY_STEP, TINY_EVAL)
    bres = benchmark.main(["--model", "lemevit_tiny", "--bench", "train",
                           "--batch-size", str(B_MAIN),
                           "--num-bench-iter", "5"])
    tr = bres["train"]
    say("bench-train", f"lemevit_tiny 224 bf16 B={tr['batch_size']}: "
        f"{tr['samples_per_sec']} img/s, step {tr['step_time']} ms, fwd "
        f"{tr['fwd_time']} ms, bwd+opt {tr['bwd_opt_time']} ms")
    prof = profile_train_step(dev, "lemevit_tiny")
    say("train-summary", json.dumps({
        "model": "lemevit_tiny", "batch": B_MAIN, "dtype": "bf16",
        "img_per_s": tiny_res["samples_per_sec"],
        "ms_per_step": tiny_res["step_ms"],
        "peak_gib": tiny_res["peak_gib"],
        "bench_train_step_ms": tr["step_time"],
        "host_batch_build_ms": host_batch_ms(),
        "device_ms_per_step": prof.get("device_ms"),
        "launches_per_step": prof.get("launches"),
        # device time over the same profiled step's wall time
        "device_busy_share": (prof["device_ms"] / prof["wall_ms"]
                              if prof else None),
        "port_kernel_share": (prof["port_ms"] / prof["device_ms"]
                              if prof else None)}))

    # 8. per-kernel numbers: per-launch means over each main path's mix
    kernels = []
    for name in ("c_block", "dca_block", "s_block"):
        kernels.append(kernel_entry(
            name, [r for r in shape_rows if r["name"] == name],
            launches[name], "per_forward",
            tiny_shapes=strip(r for r in tiny_rows if r["name"] == name),
            tiny_train_eval_launches=tiny_launches[name],
            **({"vit_tiny_train_eval_launches": vit_launches[name],
                "vit_tiny_shapes": strip(vit_eval_rows)}
               if name == "s_block" else {})))
    for name in KERNELS:
        if name in fb.LAUNCHES:
            continue
        extra = {}
        if name in VIT_STEP:
            extra = dict(vit_tiny_launches=vit_launches[name],
                         vit_tiny_shapes=strip(r for r in vit_rows
                                               if r["name"] == name))
        kernels.append(kernel_entry(
            name, [r for r in train_rows if r["name"] == name],
            tiny_launches[name], "per_step", **extra))
    say("done", f"{time.time() - t_start:.0f} s")
    print(f"kernels: {json.dumps(list(KERNELS))}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
