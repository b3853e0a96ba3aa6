"""Smoke run of lemevit_tpu_torch on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the CUDA kernels from lemevit_tpu_torch/attn/csrc and drives both
main paths of the port, each with its kernels' launch counts set to 0 just
before it and read just after:
  - serving: every inference block kernel held against its plain PyTorch
    version at the shapes of LeMeViT-Base at 224^2, base's kernel path
    against its plain path, a bf16 batch of 64 served through
    cli.benchmark's inference function, and cli.validate on synthetic data;
  - training: the three S-block training kernels (forward, MLP backward,
    attention backward) and the S inference kernel held against their plain
    versions at vit_tiny's shapes at 224^2, one fp32 train step of vit_tiny
    on the kernel path against the plain path, then cli.train on synthetic
    data (vit_tiny, 224^2, bf16, batch 64, configs/lemevit.yaml, 6 steps and
    one eval) and a profile of one train step.
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
TRAIN_STEPS = 6             # steps of the cli.train run
REPO = Path(__file__).resolve().parent

# Base at 224^2: (kernel, N, C, launches per forward)
MAIN_SHAPES = [("c_block", 3136, 96, 2),
               ("dca_block", 3136, 96, 4), ("dca_block", 784, 192, 4),
               ("s_block", 196, 384, 18), ("s_block", 49, 512, 4)]
# vit_tiny at 224^2, stages 1-3 (stage 0, N = 3136, composes as in the JAX
# package): (N, C, S blocks); each block launches every training kernel
# once per train step, and s_block once per eval forward
TINY_SHAPES = [(784, 192, 2), (196, 320, 4), (49, 384, 2)]
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
}
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
    """(bytes, operations) of one training-kernel call on both streams at
    hidden = 4C: each input read once, each output written once (fp32
    log-sum-exp rows and DropPath scales at 4 bytes); the operations
    include what the call's interface makes it recompute (qkv, fc1)."""
    rows = b * (n + M)
    pairs = b * (n * n + M * M)
    lse = 4 * b * (ch // 32) * (n + M) + 4 * 4 * b
    act = rows * ch * elt
    w_qkv, w_p, w_mlp = (3 * ch * ch + 3 * ch, ch * ch + ch,
                         8 * ch * ch + 5 * ch)
    if phase == "s_train_fwd":   # x, c -> out, t1, o (+ lse)
        return (5 * act + (w_qkv + w_p + w_mlp) * elt + lse,
                2 * rows * 12 * ch * ch + 4 * pairs * ch)
    if phase == "mlp_bwd":       # t1, dout -> dt1, dW1, db1, dW2, db2
        return 3 * act + 2 * w_mlp * elt + 4 * 2 * b, 40 * rows * ch * ch
    # s_attn_bwd: x, dt1, o, lse -> dx, dWqkv, dbqkv, dWp, dbp
    return (4 * act + 2 * (w_qkv + w_p) * elt + lse,
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


def profile_call(fn, what: str, top: int = 16) -> None:
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
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not rows:
        say("profile", f"{what}: no device time recorded: not measured")
        return
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "lm::" in r[0])
    say("profile", f"{what}: {wall_ms:.2f} ms wall, {busy:.2f} ms of "
        f"device kernels ({100 * busy / wall_ms:.1f}% busy), of which "
        f"{ours:.2f} ms in the port's kernels (lm::) and "
        f"{busy - ours:.2f} ms in PyTorch's")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        say("profile", f"{ms:8.3f} ms  {count:4d}x  {key[:90]}")


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


# the gradients of s_block_train; the last four come from the MLP
# backward, the first six from the attention backward (which also carries
# the MLP backward's dt1 into dx / dc)
GRAD_NAMES = ["dx", "dc", "dWqkv", "dbqkv", "dWp", "dbp", "dW1", "db1",
              "dW2", "db2"]


def train_inputs(b, n, ch, g, dev, dtype):
    """x, c, the LN-folded 8-tuple, DropPath scales (keep 0.85) and
    upstream gradients of one S block, seeded, in ``dtype`` on ``dev``."""
    hidden = 4 * ch

    def lin(o, i):
        return [torch.randn(o, i, generator=g) * i ** -0.5,
                torch.randn(o, generator=g) * 0.1]
    params = lin(3 * ch, ch) + lin(ch, ch) + lin(hidden, ch) + lin(ch, hidden)
    x = torch.randn(b, n, ch, generator=g)
    c = torch.randn(b, M, ch, generator=g)
    dp = (torch.rand(4, b, generator=g) < 0.85).float() / 0.85
    gx = torch.randn(b, n, ch, generator=g)
    gc = torch.randn(b, M, ch, generator=g)
    cast = [t.to(dev, dtype) for t in (x, c, *params, gx, gc)]
    return cast[0], cast[1], cast[2:10], dp.to(dev), cast[10], cast[11]


def run_train_block(fn, x, c, params, dp, gx, gc, h):
    """Outputs and the 10 gradients of fn under upstream grads gx, gc."""
    ts = [t.detach().clone().requires_grad_() for t in (x, c, *params)]
    xo, co = fn(ts[0], ts[1], ts[2:], dp, num_heads=h)
    torch.autograd.backward([xo, co], [gx.to(xo.dtype), gc.to(co.dtype)])
    return [xo.float(), co.float()], [t.grad.float() for t in ts]


def check_train_kernels(ft, n, ch, blocks, dev, g):
    """s_block_train (the three kernels under autograd) against
    s_block_train_plain: fp32 at B_CHECK, bf16 at B_MAIN against fp32 on
    the same bf16-cast inputs (TRAIN_TOL); then each kernel timed at B_MAIN
    in bf16 beside its plain phase and its bound."""
    h = ch // 32
    errs = {}
    for dtype, b in ((torch.float32, B_CHECK), (torch.bfloat16, B_MAIN)):
        x, c, p, dp, gx, gc = train_inputs(b, n, ch, g, dev, dtype)
        got_o, got_g = run_train_block(ft.s_block_train, x, c, p, dp, gx,
                                       gc, h)
        torch.cuda.synchronize()
        want_o, want_g = run_train_block(
            ft.s_block_train_plain, x.float(), c.float(),
            [t.float() for t in p], dp, gx.float(), gc.float(), h)
        otol, gtol = TRAIN_TOL[dtype]
        e_out = max_err(got_o, want_o, otol)
        e_mlp = max_grad_err(got_g[6:], want_g[6:], gtol, GRAD_NAMES[6:])
        e_attn = max_grad_err(got_g[:6], want_g[:6], gtol, GRAD_NAMES[:6])
        errs[dtype] = {"s_train_fwd": e_out, "mlp_bwd": e_mlp,
                       "s_attn_bwd": e_attn,
                       "scale": max(w.abs().max().item() for w in want_g)}
        del got_o, got_g, want_o, want_g
    # times per kernel, bf16, B_MAIN, on the inputs of the last check
    wqkv, bqkv, wp, _, w1, b1, w2, _ = p
    fwd = ft.s_train_fwd(x, c, p, dp, num_heads=h)
    t1x, t1c, ox, oc, lx, lc = fwd[2:]
    mlp = ft.mlp_bwd(t1x, t1c, gx, gc, dp, w1, b1, w2)
    calls = {
        "s_train_fwd": (lambda: ft.s_train_fwd(x, c, p, dp, num_heads=h),
                        lambda: ft.s_train_fwd_plain(x, c, p, dp,
                                                     num_heads=h)),
        "mlp_bwd": (lambda: ft.mlp_bwd(t1x, t1c, gx, gc, dp, w1, b1, w2),
                    lambda: ft.mlp_bwd_plain(t1x, t1c, gx, gc, dp, w1, b1,
                                             w2)),
        "s_attn_bwd": (
            lambda: ft.s_attn_bwd(x, c, mlp[0], mlp[1], dp, wqkv, bqkv, wp,
                                  ox, oc, lx, lc, num_heads=h),
            lambda: ft.s_attn_bwd_plain(x, c, mlp[0], mlp[1], dp, wqkv, bqkv,
                                        wp, ox, oc, lx, lc, num_heads=h)),
    }
    rows = []
    for name, (kern, plain) in calls.items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        t_bound, by = bound(*train_work(name, B_MAIN, n, ch))
        rows.append(dict(
            name=name, n=n, c=ch, batch=B_MAIN, per_step=blocks,
            err_fp32=errs[torch.float32][name],
            err_bf16=errs[torch.bfloat16][name],
            grad_scale_bf16=errs[torch.bfloat16]["scale"], ms=ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by))
    e32, e16 = errs[torch.float32], errs[torch.bfloat16]
    say("train-kernel", f"N={n} C={ch}: fp32 B=8 err out "
        f"{e32['s_train_fwd']:.2e}, grads "
        f"{max(e32['mlp_bwd'], e32['s_attn_bwd']):.2e} of max "
        f"{e32['scale']:.3g}; bf16 B=64 err out {e16['s_train_fwd']:.2e}, "
        f"grads {max(e16['mlp_bwd'], e16['s_attn_bwd']):.2e} of max "
        f"{e16['scale']:.3g} | " + "; ".join(
            f"{r['name']} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"bound {r['bound_ms']:.4f} {r['bound_by']})" for r in rows))
    return rows


def check_train_step(ft, dev):
    """One fp32 train step's loss and gradients of vit_tiny at 224^2, B=2,
    drop-path 0.15 with the same masks: the kernel path against
    --attn-backend torch. Limits: loss 1e-4 abs; each parameter's gradient
    max |err| <= 1e-3 max|ref| + 1e-6."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.steps import cross_entropy_loss
    kern = create_model("vit_tiny", device=dev, drop_path_rate=0.15).train()
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
    launched = {k: ft.LAUNCHES[k] - before[k] for k in before}
    if any(v != 8 for v in launched.values()):
        raise AssertionError(f"train step launches {launched}, expected 8 "
                             "of each training kernel")
    if not abs(losses[0] - losses[1]) <= 1e-4:
        raise AssertionError(f"train-step loss {losses[0]} vs plain "
                             f"{losses[1]}")
    worst = 0.0  # the largest error as a share of its limit
    for (name, a), b in zip(kern.named_parameters(), plain.parameters()):
        d = (a.grad - b.grad).abs().max().item()
        scale = b.grad.abs().max().item()
        if not d <= 1e-3 * scale + 1e-6:
            raise AssertionError(f"gradient of {name}: max abs err {d:.3g} "
                                 f"of max {scale:.3g}")
        worst = max(worst, d / (1e-3 * scale + 1e-6))
    say("train-step", f"vit_tiny 224 fp32 B=2: loss {losses[0]:.6f} vs plain "
        f"{losses[1]:.6f} (|diff| {abs(losses[0] - losses[1]):.2e}, limit "
        f"1e-4); gradients within {100 * worst:.1f}% of their limits "
        f"(1e-3 max|ref| + 1e-6); launches {launched}")


def train_main_path(ft, fb, dev):
    """cli.train on synthetic data: vit_tiny, 224^2, bf16, B=64, the
    reference recipe (configs/lemevit.yaml: mixup, cutmix, erasing,
    smoothing, drop-path 0.15, EMA), 1 epoch of TRAIN_STEPS steps and one
    eval of the live and EMA models. Returns the launch counts."""
    from lemevit_tpu_torch.cli import train as train_cli
    with tempfile.TemporaryDirectory() as out:
        for counts in (ft.LAUNCHES, fb.LAUNCHES):
            for k in counts:
                counts[k] = 0
        torch.cuda.reset_peak_memory_stats()
        res = train_cli.main([
            "--synthetic", "--model", "vit_tiny", "--img-size", "224",
            "--batch-size", str(B_MAIN),
            "--config", str(REPO / "configs" / "lemevit.yaml"),
            "--epochs", "1", "--steps-per-epoch", str(TRAIN_STEPS),
            "--output", out])
        launches = {**ft.LAUNCHES, "s_block": fb.LAUNCHES["s_block"]}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(Path(out) / "vit_tiny" / "summary.csv") as f:
            rows = list(csv.DictReader(f))
        if list(rows[0]) != train_cli.SUMMARY_FIELDS or len(rows) != 1:
            raise AssertionError(f"summary.csv: {rows}")
        ckpts = list((Path(out) / "vit_tiny" / "checkpoints").glob(
            "checkpoint-*.pth"))
    blocks = sum(b for _, _, b in TINY_SHAPES)
    for k in ft.LAUNCHES:
        if launches[k] != blocks * TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{TRAIN_STEPS} steps, expected {blocks} "
                                 "per step")
    eval_fwds = 2 * 2  # two val batches, live and EMA model
    if launches["s_block"] != blocks * eval_fwds:
        raise AssertionError(f"s_block: {launches['s_block']} launches in "
                             f"{eval_fwds} eval forwards")
    loss = res["train_loss"]
    if not (loss == loss and abs(loss) < 1e3) or res["steps"] != TRAIN_STEPS \
            or len(ckpts) != 1:
        raise AssertionError(f"train: {res}, checkpoints {ckpts}")
    say("train", f"vit_tiny 224 bf16 B={B_MAIN}: {res['steps']} steps, "
        f"loss {loss:.4f}, {res['samples_per_sec']:.2f} img/s, "
        f"{res['step_ms']:.2f} ms/step (steps 2-{TRAIN_STEPS}), peak "
        f"{peak_gb:.2f} GiB allocated; eval top1 {res['best_top1']:.3f}; "
        f"launches per step " + ", ".join(
            f"{k} {launches[k] // TRAIN_STEPS}" for k in ft.LAUNCHES)
        + f"; s_block {launches['s_block']} in {eval_fwds} eval forwards")
    return launches


def profile_train_step(dev):
    """torch.profiler table of one bf16 B=64 train step of vit_tiny."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from lemevit_tpu_torch.train.state import ModelEma, TrainState
    from lemevit_tpu_torch.train.steps import train_step
    model = create_model("vit_tiny", device=dev, drop_path_rate=0.15)
    model.set_generator(torch.Generator(device=dev).manual_seed(0))
    state = TrainState(model, build_optimizer(model), build_lr_schedule(),
                       ModelEma(model, 0.996))
    g = torch.Generator().manual_seed(5)
    img = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (B_MAIN,), generator=g).to(dev)
    profile_call(lambda: train_step(state, img, labels,
                                    autocast_dtype=torch.bfloat16),
                 "one train step")


def kernel_entry(name, rows, launches, weight_key):
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
        "library_ms": None,
        "shapes": [{k: v for k, v in r.items() if k != "name"}
                   for r in rows]}


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
    for k in fb.LAUNCHES:
        fb.LAUNCHES[k] = 0
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

    # 6. training: kernels at vit_tiny's shapes, one step against the plain
    #    path, then the training main path
    tiny_eval_rows = [check_block_kernel(fb, "s_block", n, ch, blocks, dev, g)
                      for n, ch, blocks in TINY_SHAPES]
    train_rows = []
    for n, ch, blocks in TINY_SHAPES:
        train_rows += check_train_kernels(ft, n, ch, blocks, dev, g)
    check_train_step(ft, dev)
    train_launches = train_main_path(ft, fb, dev)
    profile_train_step(dev)

    # 7. per-kernel numbers: per-launch means over each main path's mix
    kernels = []
    for name in ("c_block", "dca_block", "s_block"):
        entry = kernel_entry(name, [r for r in shape_rows
                                    if r["name"] == name],
                             launches[name], "per_forward")
        if name == "s_block":
            entry["train_eval_launches"] = train_launches["s_block"]
            entry["train_eval_shapes"] = [
                {k: v for k, v in r.items() if k != "name"}
                for r in tiny_eval_rows]
        kernels.append(entry)
    for name in ft.LAUNCHES:
        kernels.append(kernel_entry(
            name, [r for r in train_rows if r["name"] == name],
            train_launches[name], "per_step"))
    say("done", f"{time.time() - t_start:.0f} s")
    print(f"kernels: {json.dumps(list(KERNELS))}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
