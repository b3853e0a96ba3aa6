"""Smoke run of lemevit_tpu_torch on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the CUDA kernels from lemevit_tpu_torch/attn/csrc, holds every kernel
against its plain PyTorch version at the shapes of LeMeViT-Base at 224^2,
checks the whole model's kernel path against its plain path, serves a bf16
batch of 64 through cli.benchmark's inference function (counting kernel
launches) and runs cli.validate on synthetic data. Every phase prints one
line; any failure raises and exits non-zero. The last lines are a JSON
object of per-kernel numbers, the card's name and power limit as nvidia-smi
reports them, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

B_CHECK = 8          # batch of the fp32 kernel checks
B_MAIN = 64          # batch of the served main path (bf16)
M = 16               # meta tokens of every released variant
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak

# Base at 224^2: (kernel, N, C, launches per forward)
MAIN_SHAPES = [("c_block", 3136, 96, 2),
               ("dca_block", 3136, 96, 4), ("dca_block", 784, 192, 4),
               ("s_block", 196, 384, 18), ("s_block", 49, 512, 4)]
KERNELS = {
    "c_block": ("lemevit_tpu_torch/attn/csrc/c_block.cu",
                "lemevit_tpu/attn/pallas_block.py:1069"),
    "dca_block": ("lemevit_tpu_torch/attn/csrc/dca_block.cu",
                  "lemevit_tpu/attn/pallas_block.py:929"),
    "s_block": ("lemevit_tpu_torch/attn/csrc/s_block.cu",
                "lemevit_tpu/attn/pallas_block.py:1095"),
}


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


def profile_forward(model, x, top: int = 12) -> None:
    """Device time of one served forward by CUDA kernel name
    (torch.profiler), and the device's busy share of the forward's wall
    time. Runs after the launch count is read, so it adds no launches."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not rows:
        say("profile", "no device time recorded: not measured")
        return
    busy = sum(r[1] for r in rows)
    say("profile", f"one forward: {wall_ms:.2f} ms wall, {busy:.2f} ms of "
        f"device kernels ({100 * busy / wall_ms:.1f}% busy)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        say("profile", f"{ms:8.3f} ms  {count:4d}x  {key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        sys.exit(1)
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.attn import _build
    from lemevit_tpu_torch.attn import fused_block as fb
    from lemevit_tpu_torch.attn.reference import dca_scales
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

    # 3. kernels against their plain versions
    g = torch.Generator().manual_seed(0)
    wrappers = {"c_block": fb.c_block, "dca_block": fb.dca_block,
                "s_block": fb.s_block}
    plains = {"c_block": fb.c_block_plain, "dca_block": fb.dca_block_plain,
              "s_block": fb.s_block_plain}

    def call(fns, kind, x, c, p, n, ch):
        kw = {"num_heads": ch // 32}
        if kind == "dca_block":
            kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
        out = fns[kind](x, c, p, **kw)
        return out if isinstance(out, tuple) else (out,)

    def max_err(got, want, tol):
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

    shape_rows = []
    for kind, n, ch, per_fwd in MAIN_SHAPES:
        hidden = 4 * ch
        p32 = make_params(kind, ch, hidden, g)
        x = torch.randn(B_MAIN, n, ch, generator=g)
        c = torch.randn(B_MAIN, M, ch, generator=g)
        # fp32 at B_CHECK, rtol = atol = 1e-4
        xs, cs = x[:B_CHECK].to(dev), c[:B_CHECK].to(dev)
        ps = [t.to(dev) for t in p32]
        err32 = max_err(call(wrappers, kind, xs, cs, ps, n, ch),
                        call(plains, kind, xs, cs, ps, n, ch), 1e-4)
        # bf16 at the main path's batch, 3e-2 against fp32 on the same
        # bf16-cast inputs
        xb, cb = x.to(dev, torch.bfloat16), c.to(dev, torch.bfloat16)
        pb = [t.to(dev, torch.bfloat16) for t in p32]
        got = call(wrappers, kind, xb, cb, pb, n, ch)
        want = call(plains, kind, xb.float(), cb.float(),
                    [t.float() for t in pb], n, ch)
        err16 = max_err(got, want, 3e-2)
        del got, want
        ms = cuda_ms(lambda: call(wrappers, kind, xb, cb, pb, n, ch))
        plain_ms = cuda_ms(lambda: call(plains, kind, xb, cb, pb, n, ch))
        nbytes, flops = work(kind, B_MAIN, n, ch, hidden,
                             sum(t.numel() for t in pb) * 2, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        row = dict(name=kind, n=n, c=ch, batch=B_MAIN, per_forward=per_fwd,
                   err_fp32=err32, err_bf16=err16, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   tflops=flops / ms / 1e9)
        shape_rows.append(row)
        say("kernel", f"{kind} N={n} C={ch}: fp32 err {err32:.2e} (B=8), "
            f"bf16 err {err16:.2e} (B=64); {ms:.3f} ms vs plain "
            f"{plain_ms:.3f} ms; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); {row['tflops']:.1f} TFLOP/s")

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

    # the main path: bf16 B=64 through cli.benchmark's inference function
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
    profile_forward(model, x)
    del model

    # 5. validate on synthetic data
    vres = validate.main(["--model", "lemevit_base", "--synthetic",
                          "--batch-size", str(B_MAIN), "--max-batches", "2"])
    if not (vres["loss"] > 0 and vres["samples_per_sec"] > 0):
        raise AssertionError(f"validate: {vres}")
    say("validate", json.dumps(vres))

    # 6. per-kernel numbers: per-launch means over the main path's mix
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        rows = [r for r in shape_rows if r["name"] == name]
        w = sum(r["per_forward"] for r in rows)
        mean = lambda key: sum(r[key] * r["per_forward"] for r in rows) / w
        t_bound = mean("bound_ms")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err_bf16"] for r in rows),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": t_bound,
            "bound_by": max(rows, key=lambda r: r["bound_ms"]
                            * r["per_forward"])["bound_by"],
            "library_ms": None,
            "shapes": [{k: r[k] for k in ("n", "c", "batch", "per_forward",
                                          "err_fp32", "err_bf16", "ms",
                                          "plain_ms", "bound_ms", "bound_by")}
                       for r in rows]})
    say("done", f"{time.time() - t_start:.0f} s")
    print(f"kernels: {json.dumps(list(KERNELS))}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
