"""Smoke run of lemevit_tpu_torch on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the CUDA kernels from lemevit_tpu_torch/attn/csrc and drives the
port's main paths, each with every kernel's launch count set to 0 just
before it and read just after:
  - serving: every inference block kernel held against its plain PyTorch
    version at the shapes of LeMeViT-Base at 224^2, base's kernel path
    against its plain path, a bf16 batch of 64 served through
    cli.benchmark's inference function, and cli.validate on synthetic data;
  - serving base on the slice's path (s_stage, cpe_in_kernel): the s_stage
    kernel held against its plain version and against the chain of S block
    kernels at base's, lemevit_tiny's and UperNet's stage shapes, with and
    without CPEs; the three block kernels' cpe mode against their plain
    versions at base's shapes, timed beside the external CPE placement;
    base's slice logits against its plain path, a bf16 batch of 64 served
    beside the default path's img/s, a profile of one forward (one
    k_s_stage per S stage, no CPE convolution) and cli.validate;
  - training vit_tiny (all S blocks): the three S-block training kernels
    and the S inference kernel held against their plain versions at
    vit_tiny's shapes, one fp32 train step on the kernel path against the
    plain path, then cli.train on synthetic data (224^2, bf16, batch 64,
    configs/lemevit.yaml, 6 steps and one eval) and a profile of one train
    step; stage 0 (N = 3136) composes, its meta-token stream on the mhsa
    kernel;
  - training lemevit_tiny (C, D and S blocks): the inference kernels at its
    five shapes, its C, D and S training kernels (forward, MLP backward,
    attention backward) held against their plain versions, a D2 training
    block through the weight permutation, one fp32 train step on the kernel
    path against the plain path, cli.train as above, cli.benchmark --bench
    train, and a profile of one train step;
  - training lemevit_tiny on the slice's path (train_cpe_in_kernel: each
    block's 3x3 CPE inside its training kernels): the six C, D and S
    training kernels in their CPE mode held against their plain versions
    (the tap and bias gradients included) at lemevit_tiny's and base's
    training shapes, timed beside the external placement (F.conv2d and its
    autograd around the kernel without its CPE), the tap gradients bit for
    bit over two runs, one fp32 train step with the switch against the
    plain path, cli.train --train-cpe-in-kernel beside the default path's
    img/s and peak memory, cli.benchmark --bench train
    --train-cpe-in-kernel, and a profile of one train step (the same
    launches, no convolution for the 15 block CPEs);
  - segmentation (UperNet on lemevit_tiny, 512^2 crops, 512 head channels,
    6 classes): the attention-only kernels held against their plain
    versions (dca_attn at stages 1-2's shapes, through D2's aliasing and
    one backward; mhsa at three shapes) beside SDPA's time on the same
    inputs, the S kernels at stages 3-4's shapes (N = 1024, 256), the crop
    forward's kernel path against its plain path (fp32 at batch 1, bf16 at
    batch 8) with its launches, slide inference of a 1024^2 image (9
    windows), cli.train_seg on synthetic data (batch 8, bf16, 6 steps and
    a slide-inference eval) and a profile of one seg train step;
  - the toolchain probes (lemevit_tpu_torch/probes, built into their own
    library): the per-op probe k_ew_probe held against its plain version
    for all 12 ops at K = 1 and at vpu_probe's K on each of its three
    (R, C) tiles x 64; then the probe path, python -m
    lemevit_tpu_torch.cli.probes --ew (each construct probe, erff against
    JAX's polynomial erf, an atomicAdd scatter, 16-byte row-shifted loads,
    the C = 320 fold and thread-block clusters of 1-16, against its plain
    version in its own process; the per-op slope table at the three
    shapes; the A/B rows of s_stage, the inference and the training CPE
    placements) in a fresh process whose counts start at 0 and which
    reports its launches, and the training paths' A/B row: vit_tiny and
    cli.train_seg with --train-cpe-in-kernel beside the default runs
    above, decided by each path's bare train step's device time with the
    switch off and on in alternating pairs.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.utils.profiling import (BF16_FLOPS, FP32_FLOPS,
                                               HBM_BYTES_PER_S)

B_CHECK = 8          # batch of the fp32 kernel checks
B_MAIN = 64          # batch of the served and trained main paths (bf16)
M = 16               # meta tokens of every released variant
TRAIN_STEPS = 6             # steps of each cli.train run
REPO = Path(__file__).resolve().parent

# Base at 224^2: (kernel, N, C, launches per forward)
MAIN_SHAPES = [("c_block", 3136, 96, 2),
               ("dca_block", 3136, 96, 4), ("dca_block", 784, 192, 4),
               ("s_block", 196, 384, 18), ("s_block", 49, 512, 4)]
# base's blocks with the CPE in the kernel: (kernel, N, image width, C,
# launches per forward on the slice's path; its S blocks run in s_stage)
CPE_SHAPES = [("c_block", 3136, 56, 96, 2),
              ("dca_block", 3136, 56, 96, 4), ("dca_block", 784, 28, 192, 4),
              ("s_block", 196, 14, 384, 0), ("s_block", 49, 7, 512, 0)]
# launches per base forward on the slice's path
SLICE_FWD = {"c_block": 2, "dca_block": 8, "s_stage": 2}
# lemevit_tiny at 224^2: (kernel, N, C, launches per eval forward)
TINY_SHAPES = [("c_block", 3136, 64, 1),
               ("dca_block", 3136, 64, 2), ("dca_block", 784, 128, 2),
               ("s_block", 196, 192, 8), ("s_block", 49, 320, 2)]
# its training blocks: (kind, N, C, blocks); each block launches its
# forward, mlp_bwd and attention backward once per train step
TINY_TRAIN = [("c", 3136, 64, 1), ("dca", 3136, 64, 2), ("dca", 784, 128, 2),
              ("s", 196, 192, 8), ("s", 49, 320, 2)]
# the training kernels in their CPE mode: (kind, N, image width, C, blocks
# per lemevit_tiny step on the slice's path); base's C and D training
# shapes are timed too (no main path trains base)
TRAIN_CPE_SHAPES = [("c", 3136, 56, 64, 1), ("dca", 3136, 56, 64, 2),
                    ("dca", 784, 28, 128, 2), ("s", 196, 14, 192, 8),
                    ("s", 49, 7, 320, 2), ("c", 3136, 56, 96, 0),
                    ("dca", 3136, 56, 96, 0), ("dca", 784, 28, 192, 0)]
# the convolutions of one lemevit_tiny forward: stem 2, downsamples 3, the
# blocks' CPEs 15
TINY_CONVS, TINY_CPE_CONVS = 20, 15
# vit_tiny at 224^2, stages 1-3 (stage 0, N = 3136, composes as in the JAX
# package): S blocks, each launching s_block once per eval forward
VIT_TRAIN = [("s", 784, 192, 2), ("s", 196, 320, 4), ("s", 49, 384, 2)]
# UperNet on lemevit_tiny at 512^2 (cli.train_seg's defaults): batch, crop,
# head channels, classes; the fp32 checks' batch
SEG_B, SEG_CROP, SEG_CH, SEG_CLASSES, SEG_B_CHECK = 8, 512, 512, 6, 2
# s_stage: (stage, blocks, N, image width, C, fp32 batch, bf16 batch,
# launches per base forward on the slice's path)
STAGE_SHAPES = [("base stage 3", 18, 196, 14, 384, B_CHECK, B_MAIN, 1),
                ("base stage 4", 4, 49, 7, 512, B_CHECK, B_MAIN, 1),
                ("lemevit_tiny stage 3", 8, 196, 14, 192, B_CHECK, B_MAIN, 0),
                ("UperNet stage 3", 8, 1024, 32, 192, SEG_B_CHECK, SEG_B, 0)]
# stages 1-2 compose (N > 3136): each D block's attention is one dca_attn
# call, (N, C, blocks)
SEG_DCA = [(16384, 64, 2), (4096, 128, 2)]
# stages 3-4 run the S kernels at new token counts, (kind, N, C, blocks)
SEG_S = [("s", 1024, 192, 8), ("s", 256, 320, 2)]
# mhsa: (N, C, fp32 batch, bf16 batch): vit_tiny's stage-0 meta stream,
# an S block that composes at N = 196 and at the kernel's largest N
MHSA_SHAPES = [(16, 96, B_CHECK, B_MAIN), (196, 320, B_CHECK, B_MAIN),
               (1024, 192, SEG_B_CHECK, SEG_B)]
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
    "s_stage": ("lemevit_tpu_torch/attn/csrc/s_stage.cu",
                "lemevit_tpu/attn/pallas_block.py:1250"),
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
    "dca_attn": ("lemevit_tpu_torch/attn/csrc/dca_attn.cu",
                 "lemevit_tpu/attn/pallas_dca.py:185"),
    "mhsa": ("lemevit_tpu_torch/attn/csrc/mhsa.cu",
             "lemevit_tpu/attn/pallas_mhsa.py:95"),
}
# the probe kernels: the per-op probe per op (k_ew_probe<Op, K>) and the
# construct probes, by the construct probe (cli.probes' row) that runs them
PROBE_SRC = "lemevit_tpu_torch/probes/csrc/"
CONSTRUCT_KERNELS = {
    "erf_prim": ("erf_probe", "scripts/mosaic_probes.py:57"),
    "scatter": ("scatter_add_probe", "scripts/mosaic_probes.py:78"),
    "pltpu_roll": ("roll_rows_probe", "scripts/mosaic_probes.py:93"),
    "reshape_c320": ("fold_probe", "scripts/mosaic_probes.py:108"),
    # the construct of s_stage's cluster (s_stage.cu); no TPU kernel
    # counterpart (s_stage's TPU kernel is replaced by k_s_stage)
    "cluster": ("cluster_probe", None),
}
# launches per train step and per eval forward of each trained model
VIT_STEP = {"s_train_fwd": 8, "mlp_bwd": 8, "s_attn_bwd": 8, "mhsa": 2}
VIT_EVAL = {"s_block": 8, "mhsa": 2}
TINY_STEP = {"c_train_fwd": 1, "c_attn_bwd": 1, "dca_train_fwd": 4,
             "dca_attn_bwd": 4, "s_train_fwd": 10, "s_attn_bwd": 10,
             "mlp_bwd": 15}
TINY_EVAL = {"c_block": 1, "dca_block": 4, "s_block": 10}
# UperNet: launches per crop forward and per train_seg step
SEG_CROP_FWD = {"dca_attn": 4, "s_block": 10}
SEG_STEP = {"dca_attn": 4, "s_train_fwd": 10, "mlp_bwd": 10,
            "s_attn_bwd": 10}
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


def counters() -> tuple:
    """Every kernel's launch count: the block kernels', the training
    kernels' and the attention-only kernels'."""
    from lemevit_tpu_torch.attn import dca, fused_block, fused_train, mhsa
    return (fused_block.LAUNCHES, fused_train.LAUNCHES, dca.LAUNCHES,
            mhsa.LAUNCHES)


def launch_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def launched_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a launch_counts() copy)."""
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def reset(*counts) -> None:
    for c in counts or counters():
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


def work(kind, b, n, ch, hidden, n_params_bytes, elt, cpe=False):
    """(bytes, operations) one call must move and do: each input read
    once, each output written once; multiply-adds counted as two; with
    ``cpe`` the 3x3 CPE's 9 multiply-adds per image-token element too."""
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
    if cpe:
        flops += 18 * b * n * ch
    return io + n_params_bytes, flops


def train_work(phase, b, n, ch, elt=2, cpe=False):
    """(bytes, operations) of one training-kernel call at hidden = 4C:
    each input read once, each output written once (fp32 log-sum-exp rows
    and DropPath scales at 4 bytes); the operations include what the
    call's interface makes it recompute (qkv, q / kv, fc1). n is the image
    tokens the call sees (0 for the C block's meta-only MLP backward). With
    ``cpe`` (a forward or attention backward in its CPE mode) the taps and
    the bias are read (and their gradients written by the backward), and
    the 3x3 CPE's 9 multiply-adds per image-token element are done once in
    the forward and three times in the backward (its recomputation, the tap
    gradients, the transpose)."""
    nbytes, ops = _train_work(phase, b, n, ch, elt)
    if cpe:
        fwd = phase.endswith("_fwd")
        nbytes += 10 * ch * elt * (1 if fwd else 2)
        ops += 18 * b * n * ch * (1 if fwd else 3)
    return nbytes, ops


def cpe_pass_bytes(phase, b, n, ch, elt=2):
    """Bytes of a CPE-mode call's separate CPE passes (not part of its
    bound: each is an intermediate): k_cpe_rows reads and writes x (2 elt per
    element); the backward adds k_cpe_tap_grads (x and the fp32 du) and the
    transpose (du, dx)."""
    per = 2 * elt if phase.endswith("_fwd") else 2 * elt + 2 * (4 + elt)
    return per * b * n * ch


def _train_work(phase, b, n, ch, elt):
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
    """Max abs error over gradient tensors (or any whose elements' errors
    follow the tensor's scale); raises where |err| > tol (max|ref| + |ref|)
    within a tensor."""
    err = 0.0
    for a, r, name in zip(got, want, names):
        a = a.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} is not finite")
        d = (a - r).abs()
        lim = tol * (r.abs().max() + r.abs())
        if bool((d > lim).any()):
            raise AssertionError(f"{name}: max abs err "
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
    by_name = {}  # launches of each kernel and calls of each host op
    for e in prof.key_averages():
        by_name[e.key] = by_name.get(e.key, 0) + e.count
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
            "launches": launches, "by_name": by_name}


def check_block_kernel(fb, kind, n, ch, per_fwd, dev, g, b_check=B_CHECK,
                       b_main=B_MAIN, img_w=0):
    """One inference block kernel at one shape: fp32 at b_check (rtol =
    atol = 1e-4), bf16 at b_main (3e-2 against fp32 on the same bf16-cast
    inputs), then times, bound and rate at b_main in bf16. With img_w, the
    kernel's cpe mode: x before a seeded 3x3 CPE that the kernel applies,
    against the plain version with cpe_plain, also timed in the external
    placement (cpe_plain's F.conv2d, then the kernel without its CPE)."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    wrappers = {"c_block": fb.c_block, "dca_block": fb.dca_block,
                "s_block": fb.s_block}
    plains = {"c_block": fb.c_block_plain, "dca_block": fb.dca_block_plain,
              "s_block": fb.s_block_plain}

    def call(fns, x, c, p, cpe=None):
        kw = {"num_heads": ch // 32}
        if kind == "dca_block":
            kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
        if cpe is not None:
            kw.update(cpe=cpe, img_w=img_w)
        out = fns[kind](x, c, p, **kw)
        return out if isinstance(out, tuple) else (out,)

    hidden = 4 * ch
    p32 = make_params(kind, ch, hidden, g)
    cpe32 = ([0.3 * torch.randn(9, ch, generator=g),
              0.1 * torch.randn(ch, generator=g)] if img_w else [])
    x = torch.randn(b_main, n, ch, generator=g)
    c = torch.randn(b_main, M, ch, generator=g)
    xs, cs = x[:b_check].to(dev), c[:b_check].to(dev)
    ps = [t.to(dev) for t in p32]
    cpes = [t.to(dev) for t in cpe32] or None
    err32 = max_err(call(wrappers, xs, cs, ps, cpes),
                    call(plains, xs, cs, ps, cpes), 1e-4)
    xb, cb = x.to(dev, torch.bfloat16), c.to(dev, torch.bfloat16)
    pb = [t.to(dev, torch.bfloat16) for t in p32]
    cpeb = [t.to(dev, torch.bfloat16) for t in cpe32] or None
    got = call(wrappers, xb, cb, pb, cpeb)
    want = call(plains, xb.float(), cb.float(), [t.float() for t in pb],
                cpeb and [t.float() for t in cpeb])
    err16 = max_err(got, want, 3e-2)
    del got, want
    ms = cuda_ms(lambda: call(wrappers, xb, cb, pb, cpeb))
    plain_ms = cuda_ms(lambda: call(plains, xb, cb, pb, cpeb))
    nbytes, flops = work(kind, b_main, n, ch, hidden,
                         sum(t.numel() for t in pb + (cpeb or [])) * 2, 2,
                         cpe=bool(img_w))
    t_bound, by = bound(nbytes, flops)
    row = dict(name=kind, n=n, c=ch, batch=b_main, per_forward=per_fwd,
               err_fp32=err32, err_bf16=err16, ms=ms, plain_ms=plain_ms,
               bound_ms=t_bound, bound_by=by, tflops=flops / ms / 1e9)
    what = ""
    if img_w:
        row.update(img_w=img_w, external_cpe_ms=cuda_ms(lambda: call(
            wrappers, fb.cpe_plain(xb, *cpeb, img_w), cb, pb)))
        what = (f" with its CPE ({n // img_w}x{img_w}; external conv + "
                f"kernel {row['external_cpe_ms']:.3f} ms)")
    say("kernel", f"{kind} N={n} C={ch}{what}: fp32 err {err32:.2e} "
        f"(B={b_check}), bf16 err {err16:.2e} (B={b_main}); {ms:.3f} ms vs "
        f"plain "
        f"{plain_ms:.3f} ms; bound {t_bound:.4f} ms ({by}); "
        f"{row['tflops']:.1f} TFLOP/s")
    return row


def check_stage(fb, label, nb, n, img_w, ch, b_check, b_main, per_fwd, dev,
                g):
    """s_stage at one stage's shape, nb seeded blocks (proj and fc2 weights
    scaled by (2 nb)^-1/2 and CPE taps 0.1 N(0, 1), so x keeps its scale
    over the stage), with and without CPEs: fp32 at b_check against
    s_stage_plain (1e-4 (1 + |ref|)); bf16 at b_main against s_stage_plain
    in fp32 on the same bf16-cast inputs (3e-2 (max|ref| + |ref|): x is
    rounded to bf16 between the blocks, so an element's error follows the
    tensor's scale) and against the chain of s_block(cpe=...) kernels on
    the same bf16 inputs (3e-2 (1 + |ref|)). Then, with CPEs, the times at
    b_main in bf16 of the stage, the chain and the plain version (mean of
    5), and the bound summed over the blocks."""
    hidden = 4 * ch
    params, cpes = [], []
    for _ in range(nb):
        p = make_params("s_block", ch, hidden, g)
        p[4], p[10] = (t * (2 * nb) ** -0.5 for t in (p[4], p[10]))
        params.append(p)
        cpes.append([0.1 * torch.randn(9, ch, generator=g),
                     0.1 * torch.randn(ch, generator=g)])
    x = torch.randn(b_main, n, ch, generator=g)
    c = torch.randn(b_main, M, ch, generator=g)
    kw = dict(num_heads=ch // 32, img_w=img_w)

    def cast(dt, dtype=None):
        """(params, cpes) on the card in dt (then in dtype, if given)."""
        to = lambda ts: [t.to(dev, dt).to(dtype or dt) for t in ts]  # noqa
        return [to(p) for p in params], [to(q) for q in cpes]

    def chain(xs, cs, ps, cps):
        for j, p in enumerate(ps):
            xs, cs = fb.s_block(xs, cs, p, cpe=cps and cps[j], **kw)
        return xs, cs

    errs = {}
    for use_cpe in (False, True):
        p32, c32 = cast(torch.float32)
        c32 = c32 if use_cpe else None
        xs, cs = x[:b_check].to(dev), c[:b_check].to(dev)
        e32 = max_err(fb.s_stage(xs, cs, p32, cpes=c32, **kw),
                      fb.s_stage_plain(xs, cs, p32, cpes=c32, **kw), 1e-4)
        pb, cpb = cast(torch.bfloat16)
        pf, cpf = cast(torch.bfloat16, torch.float32)
        cpb, cpf = (cpb, cpf) if use_cpe else (None, None)
        xb, cb = x.to(dev, torch.bfloat16), c.to(dev, torch.bfloat16)
        got = fb.s_stage(xb, cb, pb, cpes=cpb, **kw)
        want = fb.s_stage_plain(xb.float(), cb.float(), pf, cpes=cpf, **kw)
        e16 = max_grad_err(got, want, 3e-2, ["stage x", "stage c"])
        scale = max(w.abs().max().item() for w in want)
        # how many elements the per-block check's 3e-2 (1 + |ref|) misses
        beyond = sum(int(((a.float() - r).abs() > 3e-2 * (1 + r.abs()))
                         .sum()) for a, r in zip(got, want))
        e_chain = max_err(got, [t.float() for t in
                                chain(xb, cb, pb, cpb)], 3e-2)
        errs[use_cpe] = (e32, e16, e_chain, scale, beyond)
        del got, want
    ms = cuda_ms(lambda: fb.s_stage(xb, cb, pb, cpes=cpb, **kw), 5, 1)
    chain_ms = cuda_ms(lambda: chain(xb, cb, pb, cpb), 5, 1)
    plain_ms = cuda_ms(lambda: fb.s_stage_plain(xb, cb, pb, cpes=cpb, **kw),
                       5, 1)
    got_n = (b_main * (n + M)) * ch
    n_params = sum(t.numel() for p in pb + cpb for t in p)
    nbytes, flops = work("s_block", b_main, n, ch, hidden, n_params * 2, 2,
                         cpe=True)
    flops *= nb  # x and c cross device memory once; every block computes
    t_bound, by = bound(nbytes, flops)
    row = dict(name="s_stage", stage=label, blocks=nb, n=n, img_w=img_w,
               c=ch, batch=b_main, per_forward=per_fwd,
               err_fp32=max(e[0] for e in errs.values()),
               err_bf16=max(e[1] for e in errs.values()),
               err_bf16_vs_chain=max(e[2] for e in errs.values()),
               bf16_beyond_elementwise=max(e[4] for e in errs.values()),
               ms=ms, chain_ms=chain_ms, plain_ms=plain_ms,
               bound_ms=t_bound, bound_by=by, tflops=flops / ms / 1e9)
    say("stage", f"s_stage {label} ({nb} blocks, N={n} C={ch}): "
        + "; ".join(f"{'with' if k else 'no'} CPEs fp32 err {e[0]:.2e} "
                    f"(B={b_check}), bf16 err {e[1]:.2e} of max |ref| "
                    f"{e[3]:.3g} ({e[4]} of {got_n} elements beyond 3e-2 "
                    f"(1 + |ref|)), vs the s_block chain {e[2]:.2e} "
                    f"(B={b_main})" for k, e in errs.items())
        + f" | {ms:.3f} ms vs chain of {nb} s_block {chain_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; bound {t_bound:.4f} ms ({by}); "
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
    an empty image stream). kw may carry a CPE (cpe=, img_w=) for the
    forward and the attention backward."""
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


def check_train_kernels(ft, kind, n, ch, blocks, dev, g, profile=False,
                        b_check=B_CHECK, b_main=B_MAIN):
    """A training block (its three kernels under autograd) against its
    autograd composition: fp32 at b_check, bf16 at b_main against fp32 on
    the same bf16-cast inputs (TRAIN_TOL); then each kernel timed at
    b_main in bf16 beside its plain phase and its bound. The last four
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
    for dtype, b in ((torch.float32, b_check), (torch.bfloat16, b_main)):
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
    # times per kernel, bf16, b_main, on the inputs of the last check
    rows = []
    for name, (kern, plain_fn) in phase_calls(ft, kind, x, c, p, dp, gx, gc,
                                              kw).items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain_fn)
        n_seen = 0 if (kind == "c" and name == "mlp_bwd") else n
        t_bound, by = bound(*train_work(name, b_main, n_seen, ch))
        if profile and name == bwd_name:
            profile_call(kern, f"{name} N={n} C={ch} B={b_main}", top=10)
        rows.append(dict(
            name=name, kind=kind, n=n, c=ch, batch=b_main, per_step=blocks,
            err_fp32=errs[torch.float32][name],
            err_bf16=errs[torch.bfloat16][name],
            grad_scale_bf16=errs[torch.bfloat16]["scale"], ms=ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by))
    e32, e16 = errs[torch.float32], errs[torch.bfloat16]
    say("train-kernel", f"{kind} N={n} C={ch}: fp32 B={b_check} err out "
        f"{e32[fwd_name]:.2e}, grads {max(e32['mlp_bwd'], e32[bwd_name]):.2e}"
        f" of max {e32['scale']:.3g}; bf16 B={b_main} err out "
        f"{e16[fwd_name]:.2e}, "
        f"grads {max(e16['mlp_bwd'], e16[bwd_name]):.2e} of max "
        f"{e16['scale']:.3g} | " + "; ".join(
            f"{r['name']} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"bound {r['bound_ms']:.4f} {r['bound_by']})" for r in rows))
    return rows


def cpe_inputs(ch, g, dev, dtype):
    """Seeded 3x3 CPE taps (9, C) and bias (C,)."""
    return [(0.3 * torch.randn(9, ch, generator=g)).to(dev, dtype),
            (0.1 * torch.randn(ch, generator=g)).to(dev, dtype)]


def check_train_cpe(ft, fb, kind, n, img_w, ch, blocks, dev, g,
                    profile=False, b_check=B_CHECK, b_main=B_MAIN):
    """A training block in its CPE mode (pre-CPE x, a seeded 3x3 CPE inside
    the kernels) against its autograd composition with the same CPE: fp32
    at b_check, bf16 at b_main against fp32 on the same bf16-cast inputs
    (TRAIN_TOL), the tap and bias gradients among the attention backward's;
    dtaps and dbias of two attention-backward runs compared bit for bit;
    then the forward and the attention backward timed at b_main in bf16
    ("CPE in") beside their plain phases and the external placement ("ext":
    cpe_plain's F.conv2d, and in the backward its autograd, around the
    kernel without its CPE). With ``profile``, the attention backward's
    device time by kernel."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    kw = {"num_heads": ch // 32}
    if kind == "dca":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
    ckw = dict(kw, img_w=img_w)
    fused = getattr(ft, f"{kind}_block_train")
    plain = getattr(ft, f"{kind}_block_train_plain")

    def with_cpe(fn):  # the CPE's taps and bias lead the parameter list
        return lambda x_, c_, ps, dp_, **k: fn(x_, c_, ps[2:], dp_,
                                               cpe=ps[:2], **k)
    fwd_name, _, bwd_name = TRAIN_PHASES[kind]
    errs = {}
    for dtype, b in ((torch.float32, b_check), (torch.bfloat16, b_main)):
        x, c, p, dp, gx, gc = train_inputs(ft, kind, b, n, ch, g, dev, dtype)
        cpe = cpe_inputs(ch, g, dev, dtype)
        reset()
        got_o, got_g = run_train_block(with_cpe(fused), x, c, cpe + p, dp,
                                       gx, gc, ckw)
        torch.cuda.synchronize()
        expect_launches(launch_counts(), {fwd_name: 1, "mlp_bwd": 1,
                                          bwd_name: 1},
                        f"{kind} block with its CPE")
        want_o, want_g = run_train_block(
            with_cpe(plain), x.float(), c.float(),
            [t.float() for t in cpe + p], dp, gx.float(), gc.float(), ckw)
        otol, gtol = TRAIN_TOL[dtype]
        names = ["dx", "dc", "dtaps", "dbias"] + [
            f"grad {i}" for i in range(len(p))]
        errs[dtype] = {
            fwd_name: max_err(got_o, want_o, otol),
            "mlp_bwd": max_grad_err(got_g[-4:], want_g[-4:], gtol,
                                    names[-4:]),
            bwd_name: max_grad_err(got_g[:-4], want_g[:-4], gtol,
                                   names[:-4]),
            "cpe": max_grad_err(got_g[2:4], want_g[2:4], gtol,
                                names[2:4]),
            "scale": max(w.abs().max().item() for w in want_g)}
        del got_o, got_g, want_o, want_g
    # bf16, b_main, on the inputs of the last check
    calls = phase_calls(ft, kind, x, c, p, dp, gx, gc, dict(ckw, cpe=cpe))
    first, second = calls[bwd_name][0](), calls[bwd_name][0]()
    repeatable = all(torch.equal(a, b) for a, b in zip(first[-2:],
                                                      second[-2:]))
    if not repeatable:
        raise AssertionError(f"{kind} N={n} C={ch}: dtaps / dbias differ "
                             "between two runs")
    del first, second
    xr = x.detach().clone().requires_grad_()
    cr = [t.detach().clone().requires_grad_() for t in cpe]
    y = fb.cpe_plain(xr, *cr, img_w)
    ext = phase_calls(ft, kind, y.detach(), c, p, dp, gx, gc, kw)
    fwd_kernel = getattr(ft, fwd_name)
    ext_ms = {
        fwd_name: cuda_ms(lambda: fwd_kernel(fb.cpe_plain(x, *cpe, img_w), c,
                                             p, dp, **kw)),
        bwd_name: cuda_ms(lambda: (ext[bwd_name][0](), torch.autograd.grad(
            y, [xr, *cr], gx, retain_graph=True)))}
    if profile:
        profile_call(calls[bwd_name][0], f"{bwd_name} with its CPE N={n} "
                     f"C={ch} B={b_main}", top=12)
    rows = []
    for name in (fwd_name, bwd_name):
        kern, plain_fn = calls[name]
        t_bound, by = bound(*train_work(name, b_main, n, ch, cpe=True))
        rows.append(dict(
            name=name, kind=kind, n=n, img_w=img_w, c=ch, batch=b_main,
            per_step=blocks, err_fp32=errs[torch.float32][name],
            err_bf16=errs[torch.bfloat16][name],
            cpe_grad_err_fp32=errs[torch.float32]["cpe"],
            cpe_grad_err_bf16=errs[torch.bfloat16]["cpe"],
            grad_scale_bf16=errs[torch.bfloat16]["scale"],
            ms=cuda_ms(kern), plain_ms=cuda_ms(plain_fn),
            external_cpe_ms=ext_ms[name], bound_ms=t_bound, bound_by=by,
            dtaps_bitwise_repeatable=repeatable))
    e32, e16 = errs[torch.float32], errs[torch.bfloat16]
    pass_ms = {name: cpe_pass_bytes(name, b_main, n, ch) / HBM_BYTES_PER_S
               * 1e3 for name in (fwd_name, bwd_name)}
    say("train-cpe", f"{kind} N={n} ({n // img_w}x{img_w}) C={ch}: fp32 "
        f"B={b_check} err out {e32[fwd_name]:.2e}, grads "
        f"{max(e32['mlp_bwd'], e32[bwd_name]):.2e} (dtaps/dbias "
        f"{e32['cpe']:.2e}) of max {e32['scale']:.3g}; bf16 B={b_main} err "
        f"out {e16[fwd_name]:.2e}, grads "
        f"{max(e16['mlp_bwd'], e16[bwd_name]):.2e} (dtaps/dbias "
        f"{e16['cpe']:.2e}) of max {e16['scale']:.3g}; dtaps bitwise "
        "repeatable | " + "; ".join(
            f"{r['name']} CPE in {r['ms']:.3f} ms (ext "
            f"{r['external_cpe_ms']:.3f}, plain {r['plain_ms']:.3f}, bound "
            f"{r['bound_ms']:.4f} {r['bound_by']}, CPE passes' bytes "
            f"{pass_ms[r['name']]:.4f})" for r in rows))
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


def check_train_step(dev, name, expect, **model_kw):
    """One fp32 train step's loss and gradients of ``name`` (with
    ``model_kw``) at 224^2, B=2, drop-path 0.15 with the same masks: the
    kernel path against --attn-backend torch. Limits: loss 1e-4 abs; each
    parameter's gradient (pos_embed's among them) max |err| <= 1e-3
    max|ref| + 1e-6."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.steps import cross_entropy_loss
    kern = create_model(name, device=dev, drop_path_rate=0.15,
                        **model_kw).train()
    plain = copy.deepcopy(kern)
    plain.set_attn_backend("torch")
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (2,), generator=g).to(dev)
    before = launch_counts()
    losses = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device=dev).manual_seed(11))
        loss = cross_entropy_loss(m(img), labels)
        loss.backward()
        losses.append(loss.item())
    launched = launched_since(before)
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
    what = "".join(f", {k}={v}" for k, v in model_kw.items())
    say("train-step", f"{name}{what} 224 fp32 B=2: loss {losses[0]:.6f} vs "
        f"plain "
        f"{losses[1]:.6f} (|diff| {abs(losses[0] - losses[1]):.2e}, limit "
        f"1e-4); gradients within {100 * worst:.1f}% of their limits "
        f"(1e-3 max|ref| + 1e-6); launches {launched}")


def train_main_path(model, per_step, per_eval, flags=()):
    """cli.train on synthetic data: ``model``, 224^2, bf16, B=64, the
    reference recipe (configs/lemevit.yaml: mixup, cutmix, erasing,
    smoothing, drop-path 0.15, EMA), 1 epoch of TRAIN_STEPS steps and one
    eval of the live and EMA models, with the extra CLI ``flags``, its
    launch counts set to 0 just before and read just after. Returns
    (launches, result)."""
    from lemevit_tpu_torch.cli import train as train_cli
    with tempfile.TemporaryDirectory() as out:
        reset()
        torch.cuda.reset_peak_memory_stats()
        res = train_cli.main([
            "--synthetic", "--model", model, "--img-size", "224",
            "--batch-size", str(B_MAIN),
            "--config", str(REPO / "configs" / "lemevit.yaml"),
            "--epochs", "1", "--steps-per-epoch", str(TRAIN_STEPS),
            "--output", out, *flags])
        launches = launch_counts()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(Path(out) / model / "summary.csv") as f:
            rows = list(csv.DictReader(f))
        if list(rows[0]) != train_cli.SUMMARY_FIELDS or len(rows) != 1:
            raise AssertionError(f"summary.csv: {rows}")
        ckpts = list((Path(out) / model / "checkpoints").glob(
            "checkpoint-*.pth"))
    eval_fwds = 2 * 2  # two val batches, live and EMA model
    want = {k: per_step.get(k, 0) * TRAIN_STEPS
            + per_eval.get(k, 0) * eval_fwds for k in launches}
    expect_launches(launches, want, f"{model} ({TRAIN_STEPS} steps, "
                    f"{eval_fwds} eval forwards)")
    loss = res["train_loss"]
    if not (loss == loss and abs(loss) < 1e3) or res["steps"] != TRAIN_STEPS \
            or len(ckpts) != 1:
        raise AssertionError(f"train: {res}, checkpoints {ckpts}")
    say("train", f"{model} {' '.join(flags)} 224 bf16 B={B_MAIN}: "
        f"{res['steps']} steps, "
        f"loss {loss:.4f}, {res['samples_per_sec']:.2f} img/s, "
        f"{res['step_ms']:.2f} ms/step (steps 2-{TRAIN_STEPS}), peak "
        f"{res['peak_gib']:.2f} GiB allocated; eval top1 "
        f"{res['best_top1']:.3f}; launches per step " + ", ".join(
            f"{k} {v}" for k, v in per_step.items())
        + "; per eval forward " + ", ".join(
            f"{k} {v}" for k, v in per_eval.items()))
    return launches, res


def profile_train_step(dev, name, **model_kw):
    """torch.profiler table of one bf16 B=64 train step of ``name`` (with
    ``model_kw``)."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from lemevit_tpu_torch.train.state import ModelEma, TrainState
    from lemevit_tpu_torch.train.steps import train_step
    model = create_model(name, device=dev, drop_path_rate=0.15, **model_kw)
    model.set_generator(torch.Generator(device=dev).manual_seed(0))
    state = TrainState(model, build_optimizer(model), build_lr_schedule(),
                       ModelEma(model, 0.996))
    g = torch.Generator().manual_seed(5)
    img = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (B_MAIN,), generator=g).to(dev)
    return profile_call(lambda: train_step(state, img, labels,
                                           autocast_dtype=torch.bfloat16),
                        f"one {name} train step"
                        + "".join(f", {k}={v}" for k, v in model_kw.items()))


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


def attn_work(name, b, n, ch, elt=2):
    """(bytes, operations) of one attention-only call: each input read
    once, each output written once, multiply-adds counted as two. dca_attn:
    q1, k1, v1, x_out (B, N, C) and q2, k2, v2, c_out (B, M, C); two
    products of B N M C per direction. mhsa: q, k, v, out (B, N, C); two
    products of B N^2 C."""
    if name == "dca_attn":
        return 4 * b * (n + M) * ch * elt, 8 * b * n * M * ch
    return 4 * b * n * ch * elt, 4 * b * n * n * ch


def sdpa_ms(groups) -> float:
    """Time of F.scaled_dot_product_attention over each (q, k, v, scale)
    of ``groups``, in (B, H, L, d) layout (copied into it beforehand):
    the library's time for the same attention, for the table only."""
    lib = [(*[t.unflatten(-1, (t.shape[-1] // 32, 32)).transpose(1, 2)
              .contiguous() for t in qkv], scale) for *qkv, scale in groups]

    def run():
        for q, k, v, scale in lib:
            F.scaled_dot_product_attention(q, k, v, scale=scale)
    return cuda_ms(run)


def check_dca_attn(n, ch, blocks, dev, g):
    """dca_attn at one of UperNet's stage 1-2 shapes against dca_plain, on
    column views of projection outputs as the D module passes them: fp32
    at SEG_B_CHECK (1e-4), bf16 at SEG_B (3e-2 against fp32 on the same
    bf16-cast inputs); D2's dca(q, q, v1, k, k, v2) on qv / kv views in
    fp32, its outputs and, through the Function (kernel forward, plain
    backward), the gradients of both projections against plain autograd
    (1e-4 of each one's largest element); then times at SEG_B in bf16
    beside the plain version and SDPA's two calls."""
    from lemevit_tpu_torch.attn import dca as dm
    from lemevit_tpu_torch.attn.reference import dca_scales
    sx, sc = dca_scales(n, M, ch)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=ch // 32)

    def views(b, dtype, parts=3):
        lin1 = torch.randn(b, n, parts * ch, generator=g).to(dev, dtype)
        lin2 = torch.randn(b, M, parts * ch, generator=g).to(dev, dtype)
        return lin1, lin2

    l1, l2 = views(SEG_B_CHECK, torch.float32)
    a32 = (*l1.split(ch, -1), *l2.split(ch, -1))
    err32 = max_err(dm.dca_kernel(*a32, **kw), dm.dca_plain(*a32, **kw),
                    1e-4)
    l1, l2 = views(SEG_B, torch.bfloat16)
    a16 = (*l1.split(ch, -1), *l2.split(ch, -1))
    err16 = max_err(dm.dca_kernel(*a16, **kw),
                    dm.dca_plain(*[t.float() for t in a16], **kw), 3e-2)

    # D2: q and k passed twice, one backward through the Function
    lin1, lin2 = (t.requires_grad_() for t in views(SEG_B_CHECK,
                                                    torch.float32, 2))
    wx = torch.randn(SEG_B_CHECK, n, ch, generator=g).to(dev)
    wc = torch.randn(SEG_B_CHECK, M, ch, generator=g).to(dev)

    def run(fn):
        lin1.grad = lin2.grad = None
        q, v1 = lin1.split(ch, -1)
        k, v2 = lin2.split(ch, -1)
        xo, co = fn(q, q, v1, k, k, v2, **kw)
        ((xo * wx).sum() + (co * wc).sum()).backward()
        return [xo.detach(), co.detach()], [lin1.grad, lin2.grad]
    before = launch_counts()
    got_o, got_g = run(dm.dca)
    if launched_since(before) != {"dca_attn": 1}:
        raise AssertionError(f"dca D2 launches {launched_since(before)}")
    want_o, want_g = run(dm.dca_plain)
    err_d2 = max(max_err(got_o, want_o, 1e-4),
                 max_grad_err(got_g, want_g, 1e-4, ["dqv", "dkv"]))
    del lin1, lin2, got_g, want_g

    ms = cuda_ms(lambda: dm.dca_kernel(*a16, **kw))
    plain_ms = cuda_ms(lambda: dm.dca_plain(*a16, **kw))
    lib_ms = sdpa_ms([(a16[0], a16[4], a16[5], sx),
                      (a16[3], a16[1], a16[2], sc)])
    t_bound, by = bound(*attn_work("dca_attn", SEG_B, n, ch))
    row = dict(name="dca_attn", n=n, c=ch, batch=SEG_B, per_step=blocks,
               err_fp32=err32, err_bf16=err16, err_d2_fp32=err_d2, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=t_bound,
               bound_by=by)
    say("attn-kernel", f"dca_attn N={n} C={ch} M={M}: fp32 err {err32:.2e} "
        f"(B={SEG_B_CHECK}), bf16 err {err16:.2e} (B={SEG_B}), D2 aliasing "
        f"out / grads err {err_d2:.2e}; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, SDPA x2 {lib_ms:.4f} ms; bound "
        f"{t_bound:.4f} ms ({by})")
    return row


def check_mhsa(n, ch, b_check, b_main, dev, g):
    """mhsa at one shape against mhsa_plain, on column views of a qkv
    projection: fp32 at b_check (1e-4), bf16 at b_main (3e-2 against fp32
    on the same bf16-cast inputs); then times at b_main in bf16 beside the
    plain version and one SDPA call."""
    from lemevit_tpu_torch.attn import mhsa as mm
    kw = dict(scale=32 ** -0.5, num_heads=ch // 32)
    errs = []
    for b, dtype, tol in ((b_check, torch.float32, 1e-4),
                          (b_main, torch.bfloat16, 3e-2)):
        qkv = torch.randn(b, n, 3 * ch, generator=g).to(dev, dtype)
        args = qkv.split(ch, -1)
        errs.append(max_err([mm.mhsa_kernel(*args, **kw)],
                            [mm.mhsa_plain(*[t.float() for t in args],
                                           **kw)], tol))
    ms = cuda_ms(lambda: mm.mhsa_kernel(*args, **kw))
    plain_ms = cuda_ms(lambda: mm.mhsa_plain(*args, **kw))
    lib_ms = sdpa_ms([(*args, kw["scale"])])
    t_bound, by = bound(*attn_work("mhsa", b_main, n, ch))
    say("attn-kernel", f"mhsa N={n} C={ch}: fp32 err {errs[0]:.2e} "
        f"(B={b_check}), bf16 err {errs[1]:.2e} (B={b_main}); {ms:.4f} ms "
        f"vs plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; bound "
        f"{t_bound:.4f} ms ({by})")
    return dict(name="mhsa", n=n, c=ch, batch=b_main, err_fp32=errs[0],
                err_bf16=errs[1], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=t_bound, bound_by=by)


def expect_launches(launched: dict, want: dict, what: str) -> None:
    """Raise unless exactly the kernels of ``want`` launched, as often."""
    got = {k: v for k, v in launched.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def seg_serving(dev, g) -> dict:
    """UperNet's crop forward (eval, 512^2), kernel path against plain
    path: fp32 logits at batch 1 (1e-3 of max(1, max |ref|)) and bf16
    (autocast) at SEG_B against the plain path in fp32 (max abs error over
    max |ref| at most 5e-2, argmax agreement at least 0.99), launches per
    crop forward; crop-forward img/s at SEG_B in bf16; then slide
    inference of a 1024^2 image (9 windows) at batch 1 in bf16, its
    launches and ms per image."""
    from lemevit_tpu_torch.tasks.upernet import create_upernet, slide_inference
    model = create_upernet("lemevit_tiny", SEG_CLASSES, channels=SEG_CH,
                           device=dev, seed=0).eval()
    bf16 = lambda: torch.autocast("cuda", dtype=torch.bfloat16)  # noqa: E731
    img1 = torch.randn(1, SEG_CROP, SEG_CROP, 3, generator=g).to(dev)
    img8 = torch.randn(SEG_B, SEG_CROP, SEG_CROP, 3, generator=g).to(dev)
    with torch.inference_mode():
        reset()
        fused = model(img1)
        expect_launches(launch_counts(), SEG_CROP_FWD, "UperNet crop fwd")
        with bf16():
            got = model(img8)
        model.backbone.set_attn_backend("torch")
        plain = model(img1)
        want = model(img8)
        model.backbone.set_attn_backend("auto")
    err32 = (fused - plain).abs().max().item()
    lim = 1e-3 * max(1.0, plain.abs().max().item())
    rel16 = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if not (fused.shape == (1, SEG_CROP, SEG_CROP, SEG_CLASSES)
            and torch.isfinite(got).all() and err32 <= lim
            and rel16 <= 5e-2 and agree >= 0.99):
        raise AssertionError(f"UperNet kernel vs plain: fp32 {err32:.3g} "
                             f"(limit {lim:.3g}), bf16 {rel16:.3g} of max "
                             f"|ref|, argmax agreement {agree:.4f}")
    del fused, plain, got, want
    with torch.inference_mode(), bf16():
        for _ in range(2):
            model(img8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            model(img8)
        torch.cuda.synchronize()
        crop_s = (time.perf_counter() - t0) / 5
    big = torch.randn(1, 2 * SEG_CROP, 2 * SEG_CROP, 3, generator=g).to(dev)

    def slide():
        with torch.inference_mode(), bf16():
            return slide_inference(model, big, SEG_CLASSES,
                                   crop_size=SEG_CROP, stride=384)
    slide()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    out = slide()
    torch.cuda.synchronize()
    slide_ms = (time.perf_counter() - t0) * 1e3
    slide_launches = launch_counts()
    expect_launches(slide_launches, {k: 9 * v for k, v in
                                     SEG_CROP_FWD.items()}, "slide")
    if out.shape != (1, 2 * SEG_CROP, 2 * SEG_CROP, SEG_CLASSES) \
            or not torch.isfinite(out).all():
        raise AssertionError("slide inference logits")
    res = {"fp32_err": err32, "bf16_rel_err": rel16, "argmax_agree": agree,
           "crop_img_per_s": SEG_B / crop_s, "crop_ms": crop_s * 1e3,
           "slide_ms_per_1024_image": slide_ms}
    say("seg-serve", f"UperNet lemevit_tiny {SEG_CROP}^2 crop forward: "
        f"kernel vs plain fp32 B=1 err {err32:.2e} (limit {lim:.2e}); "
        f"bf16 B={SEG_B} err {rel16:.2e} of max |ref|, argmax agreement "
        f"{agree:.4f}; launches per crop "
        + ", ".join(f"{k} {v}" for k, v in SEG_CROP_FWD.items())
        + f"; bf16 B={SEG_B} {res['crop_img_per_s']:.2f} img/s "
        f"({res['crop_ms']:.2f} ms); slide inference 1024^2 (9 windows) "
        f"{slide_ms:.2f} ms per image")
    return res


def seg_main_path(flags=()) -> tuple:
    """cli.train_seg on synthetic data with its defaults (lemevit_tiny,
    512^2, batch 8, bf16) and the extra CLI ``flags``, 6 steps and one
    slide-inference eval of the 8 validation images, its launch counts set
    to 0 just before and read just after. Returns (launches, result)."""
    from lemevit_tpu_torch.cli import train_seg
    steps = TRAIN_STEPS
    with tempfile.TemporaryDirectory() as out:
        reset()
        res = train_seg.main(["--synthetic", "--iters", str(steps),
                              "--eval-interval", str(steps), "--output",
                              out, *flags])
        launches = launch_counts()
        ckpts = list((Path(out) / "checkpoints").glob("checkpoint-*.pth"))
    windows = SEG_B  # 8 validation images of one 512^2 window each
    want = {k: v * steps for k, v in SEG_STEP.items()}
    for k, v in SEG_CROP_FWD.items():
        want[k] = want.get(k, 0) + v * windows
    expect_launches(launches, want, f"train_seg ({steps} steps, {windows} "
                    "eval windows)")
    m = res["final_metrics"]
    if not (res["steps"] == steps and len(ckpts) == 1
            and abs(res["loss"]) < 1e3 and set(m) == {"mIoU", "OA", "mF1"}
            and all(0 <= v <= 100 for v in m.values())):
        raise AssertionError(f"train_seg: {res}, checkpoints {ckpts}")
    say("train-seg", f"UperNet lemevit_tiny {' '.join(flags)} {SEG_CROP}^2 "
        f"bf16 B={SEG_B}: "
        f"{steps} steps, loss {res['loss']:.4f}, "
        f"{res['samples_per_sec']:.2f} img/s, {res['step_ms']:.2f} ms/step "
        f"(steps 2-{steps}), peak {res['peak_gib']:.2f} GiB allocated; eval "
        + json.dumps({k: round(v, 3) for k, v in m.items()})
        + "; launches per step " + ", ".join(
            f"{k} {v}" for k, v in SEG_STEP.items()))
    return launches, res


def profile_seg_step(dev) -> dict:
    """torch.profiler table of one bf16 SEG_B UperNet train step."""
    from lemevit_tpu_torch.cli.train_seg import seg_train_step
    from lemevit_tpu_torch.tasks.upernet import create_upernet
    model = create_upernet("lemevit_tiny", SEG_CLASSES, channels=SEG_CH,
                           device=dev, seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=0.05)
    g = torch.Generator().manual_seed(6)
    img = torch.randint(0, 256, (SEG_B, SEG_CROP, SEG_CROP, 3), generator=g,
                        dtype=torch.uint8).to(dev)
    mask = torch.randint(0, SEG_CLASSES, (SEG_B, SEG_CROP, SEG_CROP),
                         generator=g).to(dev)
    return profile_call(lambda: seg_train_step(
        model, opt, 1e-4, img, mask, autocast_dtype=torch.bfloat16),
        "one UperNet train step")


def serve_slice(dev, g, default_res, prof_default) -> tuple:
    """Base at 224^2 on the slice's path (s_stage, cpe_in_kernel): fp32
    logits at B=2 against the plain path (1e-3) with SLICE_FWD's launches;
    the main path, a bf16 batch of B_MAIN through cli.benchmark's inference
    function, its launch counts set to 0 just before and read just after;
    a profile of one forward, which must show one k_s_stage launch per S
    stage and 32 fewer convolutions (the blocks' CPEs) than the default
    path's profile; cli.validate --s-stage --cpe-in-kernel. Returns (main
    path launches, result)."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.cli import benchmark, validate
    kw = dict(s_stage=True, cpe_in_kernel=True)
    model = create_model("lemevit_base", device=dev, **kw).eval()
    img = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    with torch.no_grad():
        reset()
        fused = model(img)
        expect_launches(launch_counts(), SLICE_FWD, "base slice forward")
        model.set_attn_backend("torch")
        plain = model(img)
    err = (fused - plain).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"base slice logits vs plain path {err:.3g}")
    del model

    args = benchmark.build_parser().parse_args(
        ["--model", "lemevit_base", "--batch-size", str(B_MAIN),
         "--num-warm-iter", "2", "--num-bench-iter", "10", "--s-stage",
         "--cpe-in-kernel"])
    model = create_model("lemevit_base", device=dev, dtype=torch.bfloat16,
                         **kw).eval()
    x = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    reset()
    res, logits = benchmark.run_inference(args, model, x)
    launches = launch_counts()
    n_fwd = args.num_warm_iter + args.num_bench_iter
    expect_launches(launches, {k: v * n_fwd for k, v in SLICE_FWD.items()},
                    f"lemevit_base slice path, {n_fwd} forwards")
    if logits.shape != (B_MAIN, 1000) or not torch.isfinite(logits).all():
        raise AssertionError("slice-path logits are not finite (64, 1000)")
    say("serve-slice", f"lemevit_base 224 bf16 B={B_MAIN} with s_stage and "
        f"the CPE in the kernels: {res['samples_per_sec']} img/s, "
        f"{res['step_time']} ms/step (default path in this run: "
        f"{default_res['samples_per_sec']} img/s, "
        f"{default_res['step_time']} ms); fp32 B=2 logits vs plain path "
        f"{err:.2e} (limit 1e-3); launches per forward " + ", ".join(
            f"{k} {launches[k] // n_fwd}" for k in SLICE_FWD))
    with torch.inference_mode():
        prof = profile_call(lambda: model(x), "one forward on the slice path")
    del model
    if not prof or not prof_default:
        raise AssertionError("the profiler recorded no device time")
    stages = sum(v for k, v in prof["by_name"].items() if "k_s_stage" in k)
    convs = [p["by_name"].get("aten::conv2d", 0)
             for p in (prof_default, prof)]
    if stages != SLICE_FWD["s_stage"] or convs[0] - convs[1] != 32:
        raise AssertionError(f"slice profile: {stages} k_s_stage launches, "
                             f"{convs[1]} convolutions against the default "
                             f"path's {convs[0]}")
    say("serve-slice", f"profile: {stages} k_s_stage launches (one per S "
        f"stage), {convs[1]} convolutions (the default path: {convs[0]}, "
        "its 32 CPEs among them)")
    vres = validate.main(["--model", "lemevit_base", "--synthetic",
                          "--batch-size", str(B_MAIN), "--max-batches", "2",
                          "--s-stage", "--cpe-in-kernel"])
    if not (vres["loss"] > 0 and vres["samples_per_sec"] > 0):
        raise AssertionError(f"validate slice: {vres}")
    say("validate", "--s-stage --cpe-in-kernel " + json.dumps(vres))
    return launches, {"img_per_s": res["samples_per_sec"],
                      "ms_per_forward": res["step_time"],
                      "default_img_per_s": default_res["samples_per_sec"],
                      "fp32_logits_err": err,
                      "device_ms_per_forward": prof["device_ms"],
                      "profiled_wall_ms": prof["wall_ms"],
                      "convolutions": convs[1]}


def check_ew_probes(dev) -> list:
    """k_ew_probe against ew_probe_plain for every op at K = 1 and at
    vpu_probe's K on each of its three (R, C) tiles x 64 (within
    ew.max_ulps bf16 steps, ew.ATOL near zero; at C = 384 and 784 a warp's
    lanes hold unequal counts of 16-byte vectors, so the masked loads,
    stores and row reductions run), and the K = 0 copy exact; each timed
    at K = 1 beside its plain version, the one PyTorch call computing it
    where there is one, and its bound. One row per op and shape."""
    from lemevit_tpu_torch.probes import ew
    rows = []
    for r, c in ew.SHAPES:
        x = ew.probe_input(r, c, dev)
        if not torch.equal(ew.ew_probe(x, "fma", 0), x):
            raise AssertionError(f"ew_probe K=0 ({r}, {c}): not a copy")
        for op in ew.OPS:
            k = ew.jax_k(op)
            got1, want1 = ew.ew_probe(x, op, 1), ew.ew_probe_plain(x, op, 1)
            m1 = ew.mismatches(got1, want1, 1)
            mk = ew.mismatches(ew.ew_probe(x, op, k),
                               ew.ew_probe_plain(x, op, k), k)
            if m1["bad"] or mk["bad"]:
                raise AssertionError(f"ew_probe {op} ({r}, {c}): K=1 {m1}, "
                                     f"K={k} {mk}")
            lib = ew.LIBRARY.get(op)
            t_bytes = ew.pass_bytes(*x.shape) / HBM_BYTES_PER_S * 1e3
            t_ops = x.numel() * ew.OP_FLOPS[op] / FP32_FLOPS * 1e3
            rows.append({
                "name": f"ew_probe.{op}", "shape": list(x.shape),
                "max_ulp_k1": m1["max_ulp"], f"max_ulp_k{k}": mk["max_ulp"],
                "err_bf16": (got1.float() - want1.float()).abs().max().item(),
                "ms": cuda_ms(lambda: ew.ew_probe(x, op, 1), 30),
                "plain_ms": cuda_ms(lambda: ew.ew_probe_plain(x, op, 1), 30),
                "library_ms": cuda_ms(lambda: lib(x), 30) if lib else None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            q = rows[-1]
            say("probe", f"ew_probe {op} {x.shape[0]}x{c} bf16: K=1 "
                f"{q['max_ulp_k1']} / K={k} {mk['max_ulp']} bf16 steps from "
                f"plain (limits {ew.max_ulps(1)} / {ew.max_ulps(k)}); K=1 "
                f"{q['ms']:.4f} ms (plain {q['plain_ms']:.4f}, library "
                f"{q['library_ms'] if lib else 'none'}, bound "
                f"{q['bound_ms']:.4f} {q['bound_by']})")
    return rows


def probes_main_path() -> dict:
    """The probe path, ``python -m lemevit_tpu_torch.cli.probes --ew
    --train-paths none`` (the training paths' A/B row is built here from
    this script's own runs), in a fresh process: its kernel counts start at
    0 and its JSON reports every launch it made. Returns that JSON."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "HOPPER_PROBES.json"
        proc = subprocess.run(
            [sys.executable, "-m", "lemevit_tpu_torch.cli.probes", "--ew",
             "--train-paths", "none", "--out", str(out)], cwd=REPO,
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"cli.probes exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        table = json.loads(out.read_text())
    for name, (kernel, _) in CONSTRUCT_KERNELS.items():
        row = table[name]
        if not (row["ok"] and row["route"] == "cuda"
                and row["verdict"].startswith(("keep", "FLIP"))):
            raise AssertionError(f"cli.probes {name}: {row}")
        say("probe", f"{name}: {row['verdict']}; {row['ms']:.4f} ms "
            f"(plain {row['plain_ms']:.4f}, library {row['library_ms']}, "
            f"bound {row['bound_ms']:.6f})")
    missing = [k for k in ["erf_probe", "scatter_add_probe",
                           "roll_rows_probe", "fold_probe", "cluster_probe"]
               + [f"ew_probe.{op}" for op in table["ew"][0]["us_per_pass"]]
               if not table["launches"].get(k)]
    if missing or len(table["ew"]) != 3:
        raise AssertionError(f"cli.probes: no launch of {missing}, "
                             f"{len(table['ew'])} slope rows")
    return table


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
        "library_ms": (mean("library_ms") if all("library_ms" in r
                                                 for r in rows) else None),
        "shapes": strip(rows), **extra}


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
    from lemevit_tpu_torch import probes
    from lemevit_tpu_torch.cli import probes as probes_cli
    from lemevit_tpu_torch.probes import ew

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

    # 2. build the model kernels and, beside them, the probes' library
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        built = [pool.submit(_build.build), pool.submit(probes.build)]
        lib_path, probe_path = [f.result() for f in built]
    _build.library()
    probes.library()
    say("build", f"{lib_path.name} and {probe_path.name} in "
        f"{time.time() - t0:.1f} s")

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
    reset()
    res, logits = benchmark.run_inference(args, model, x)
    launches = launch_counts()
    n_fwd = args.num_warm_iter + args.num_bench_iter
    expect = {"c_block": 2, "dca_block": 8, "s_block": 22}
    expect_launches(launches, {k: per * n_fwd for k, per in expect.items()},
                    f"lemevit_base, {n_fwd} forwards")
    if logits.shape != (B_MAIN, 1000) or not torch.isfinite(logits).all():
        raise AssertionError("main-path logits are not finite (64, 1000)")
    say("serve", f"lemevit_base 224 bf16 B={B_MAIN}: "
        f"{res['samples_per_sec']} img/s, {res['step_time']} ms/step; "
        f"launches per forward " + ", ".join(
            f"{k} {launches[k] // n_fwd}" for k in expect))
    with torch.inference_mode():
        prof_default = profile_call(lambda: model(x), "one forward")
    del model

    # 5. validate on synthetic data
    vres = validate.main(["--model", "lemevit_base", "--synthetic",
                          "--batch-size", str(B_MAIN), "--max-batches", "2"])
    if not (vres["loss"] > 0 and vres["samples_per_sec"] > 0):
        raise AssertionError(f"validate: {vres}")
    say("validate", json.dumps(vres))

    # 5b. the slice's path: s_stage and the blocks' in-kernel CPE against
    #     their plain versions, then base served through them
    stage_rows = [check_stage(fb, *shape, dev, g) for shape in STAGE_SHAPES]
    cpe_rows = [check_block_kernel(fb, kind, n, ch, per_fwd, dev, g,
                                   img_w=w)
                for kind, n, w, ch, per_fwd in CPE_SHAPES]
    slice_launches, slice_res = serve_slice(dev, g, res, prof_default)

    # 6. training vit_tiny (all S): the inference and training kernels at
    #    its shapes, one step against the plain path, then its main path and
    #    a profile of one train step
    vit_eval_rows = [check_block_kernel(fb, "s_block", n, ch, blocks, dev, g)
                     for _, n, ch, blocks in VIT_TRAIN]
    vit_rows = []
    for kind, n, ch, blocks in VIT_TRAIN:
        vit_rows += check_train_kernels(ft, kind, n, ch, blocks, dev, g)
    check_train_step(dev, "vit_tiny", VIT_STEP)
    vit_launches, vit_res = train_main_path("vit_tiny", VIT_STEP, VIT_EVAL)
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
    check_train_step(dev, "lemevit_tiny", TINY_STEP)
    tiny_launches, tiny_res = train_main_path("lemevit_tiny", TINY_STEP,
                                              TINY_EVAL)
    bres = benchmark.main(["--model", "lemevit_tiny", "--bench", "train",
                           "--batch-size", str(B_MAIN),
                           "--num-bench-iter", "5"])
    tr = bres["train"]
    say("bench-train", f"lemevit_tiny 224 bf16 B={tr['batch_size']}: "
        f"{tr['samples_per_sec']} img/s, step {tr['step_time']} ms, fwd "
        f"{tr['fwd_time']} ms, bwd+opt {tr['bwd_opt_time']} ms")
    prof = profile_train_step(dev, "lemevit_tiny")

    # 7b. the slice's path: lemevit_tiny trained with each block's 3x3 CPE
    #     inside its training kernels
    cpe_train_rows = []
    for kind, n, w, ch, blocks in TRAIN_CPE_SHAPES:
        cpe_train_rows += check_train_cpe(ft, fb, kind, n, w, ch, blocks, dev,
                                          g, profile=(n, ch) == (3136, 64))
    check_train_step(dev, "lemevit_tiny", TINY_STEP, train_cpe_in_kernel=True)
    slice_train_launches, slice_train_res = train_main_path(
        "lemevit_tiny", TINY_STEP, TINY_EVAL, ["--train-cpe-in-kernel"])
    sres = benchmark.main(["--model", "lemevit_tiny", "--bench", "train",
                           "--batch-size", str(B_MAIN),
                           "--num-bench-iter", "5", "--train-cpe-in-kernel"])
    st = sres["train"]
    say("bench-train", f"lemevit_tiny --train-cpe-in-kernel 224 bf16 "
        f"B={st['batch_size']}: {st['samples_per_sec']} img/s, step "
        f"{st['step_time']} ms, fwd {st['fwd_time']} ms, bwd+opt "
        f"{st['bwd_opt_time']} ms (default path: {tr['samples_per_sec']} "
        f"img/s, step {tr['step_time']} ms)")
    reset()
    slice_prof = profile_train_step(dev, "lemevit_tiny",
                                    train_cpe_in_kernel=True)
    # profile_call runs the step twice (a warm-up and the profiled one)
    expect_launches(launch_counts(), {k: 2 * v for k, v in TINY_STEP.items()},
                    "two profiled lemevit_tiny steps with the CPE inside")
    if not prof or not slice_prof:
        raise AssertionError("the profiler recorded no device time")
    convs = [pr["by_name"].get("aten::conv2d", 0) for pr in (prof,
                                                             slice_prof)]
    per = convs[0] // TINY_CONVS
    if not (per >= 1 and convs[0] == TINY_CONVS * per
            and convs[1] == (TINY_CONVS - TINY_CPE_CONVS) * per):
        raise AssertionError(f"slice train profile: {convs[1]} convolutions "
                             f"against the default path's {convs[0]}")
    say("train-slice", f"profile: {convs[1]} aten::conv2d calls (the default "
        f"path: {convs[0]}, its {TINY_CPE_CONVS} block CPEs among them); "
        f"cli.train {slice_train_res['samples_per_sec']:.2f} img/s, peak "
        f"{slice_train_res['peak_gib']:.2f} GiB (default path in this run: "
        f"{tiny_res['samples_per_sec']:.2f} img/s, "
        f"{tiny_res['peak_gib']:.2f} GiB)")
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
                              if prof else None),
        "slice": {
            "flags": "--train-cpe-in-kernel",
            "img_per_s": slice_train_res["samples_per_sec"],
            "ms_per_step": slice_train_res["step_ms"],
            "peak_gib": slice_train_res["peak_gib"],
            "bench_train_step_ms": st["step_time"],
            "device_ms_per_step": slice_prof["device_ms"],
            "launches_per_step": slice_prof["launches"],
            "device_busy_share": (slice_prof["device_ms"]
                                  / slice_prof["wall_ms"]),
            "port_kernel_share": (slice_prof["port_ms"]
                                  / slice_prof["device_ms"]),
            "conv2d_calls": convs[1]}}))

    # 8. segmentation, UperNet on lemevit_tiny at 512^2: the attention-only
    #    kernels (dca_attn at stages 1-2's shapes, mhsa at its three) and
    #    the S kernels at stages 3-4's, the crop forward and slide
    #    inference, then its main path cli.train_seg and a profile
    dca_rows = [check_dca_attn(n, ch, blocks, dev, g)
                for n, ch, blocks in SEG_DCA]
    mhsa_rows = [check_mhsa(n, ch, bc, bm, dev, g)
                 for n, ch, bc, bm in MHSA_SHAPES]
    for row, per in zip(mhsa_rows, (VIT_STEP["mhsa"], 0, 0)):
        row["per_step"] = per  # only N = 16 runs on a main path (vit_tiny)
    seg_eval_rows = [check_block_kernel(fb, "s_block", n, ch, blocks, dev, g,
                                        b_check=SEG_B_CHECK, b_main=SEG_B)
                     for _, n, ch, blocks in SEG_S]
    seg_train_rows = []
    for kind, n, ch, blocks in SEG_S:
        seg_train_rows += check_train_kernels(
            ft, kind, n, ch, blocks, dev, g, b_check=SEG_B_CHECK,
            b_main=SEG_B)
    serve = seg_serving(dev, g)
    seg_launches, seg_res = seg_main_path()
    seg_prof = profile_seg_step(dev)
    say("seg-summary", json.dumps({
        "model": "UperNet lemevit_tiny", "crop": SEG_CROP, "batch": SEG_B,
        "dtype": "bf16", "train_img_per_s": seg_res["samples_per_sec"],
        "train_ms_per_step": seg_res["step_ms"],
        "train_peak_gib": seg_res["peak_gib"],
        "final_metrics": seg_res["final_metrics"], **serve,
        "device_ms_per_step": seg_prof.get("device_ms"),
        "launches_per_step": seg_prof.get("launches"),
        "device_busy_share": (seg_prof["device_ms"] / seg_prof["wall_ms"]
                              if seg_prof else None),
        "port_kernel_share": (seg_prof["port_ms"] / seg_prof["device_ms"]
                              if seg_prof else None)}))

    # 8b. the probes: the per-op kernel against its plain version here,
    #     then the probe path (cli.probes: each construct probe against
    #     its plain version, timed, in a process of its own) and the
    #     training paths' A/B row, the CLI runs of lemevit_tiny, vit_tiny
    #     and train_seg reused from above, decided by the bare steps'
    #     device time in alternating pairs
    ew_rows = check_ew_probes(dev)
    t0 = time.time()
    table = probes_main_path()
    say("probes", f"cli.probes --ew in {time.time() - t0:.0f} s, launches "
        + json.dumps(table["launches"]))
    for row in table["ew"]:
        say("ew-slope", ew.format_row(row))
    _, vit_sw = train_main_path("vit_tiny", VIT_STEP, VIT_EVAL,
                                ["--train-cpe-in-kernel"])
    _, seg_sw = seg_main_path(["--train-cpe-in-kernel"])

    def ab(res):
        return {"img_per_s": res["samples_per_sec"],
                "ms_per_step": res["step_ms"], "peak_gib": res["peak_gib"]}
    table["pb_train_paths"] = {
        name: probes_cli.train_path_row(
            ab(default), ab(switch), probes_cli.step_device_ms(name, dev))
        for name, default, switch in (
            ("lemevit_tiny", tiny_res, slice_train_res),
            ("vit_tiny", vit_res, vit_sw), ("train_seg", seg_res, seg_sw))}
    say("probes-ab", json.dumps({
        k: (v["verdict"] if "verdict" in v else
            {kk: vv["verdict"] for kk, vv in v.items()})
        for k, v in table.items()
        if isinstance(v, dict) and k not in ("launches",)}))
    say("probes-train-paths", json.dumps(table["pb_train_paths"]))

    # 9. per-kernel numbers: per-launch means over each main path's mix
    kernels = []
    for name in ("c_block", "dca_block", "s_block"):
        kernels.append(kernel_entry(
            name, [r for r in shape_rows if r["name"] == name],
            launches[name], "per_forward",
            cpe_shapes=strip(r for r in cpe_rows if r["name"] == name),
            slice_launches=slice_launches[name],
            tiny_shapes=strip(r for r in tiny_rows if r["name"] == name),
            tiny_train_eval_launches=tiny_launches[name],
            **({"vit_tiny_train_eval_launches": vit_launches[name],
                "vit_tiny_shapes": strip(vit_eval_rows),
                "seg_train_eval_launches": seg_launches[name],
                "seg_shapes": strip(seg_eval_rows)}
               if name == "s_block" else {})))
    for name in KERNELS:
        if name in fb.LAUNCHES or name in ("dca_attn", "mhsa"):
            continue
        extra = {}
        if name in VIT_STEP:
            extra = dict(vit_tiny_launches=vit_launches[name],
                         vit_tiny_shapes=strip(r for r in vit_rows
                                               if r["name"] == name))
        if name in SEG_STEP:
            extra.update(seg_launches=seg_launches[name],
                         seg_shapes=strip(r for r in seg_train_rows
                                          if r["name"] == name))
        extra.update(slice_launches=slice_train_launches[name])
        if name != "mlp_bwd":
            extra["cpe_shapes"] = strip(r for r in cpe_train_rows
                                        if r["name"] == name)
        kernels.append(kernel_entry(
            name, [r for r in train_rows if r["name"] == name],
            tiny_launches[name], "per_step", **extra))
    kernels.append(kernel_entry(
        "s_stage", [r for r in stage_rows if r["per_forward"]],
        slice_launches["s_stage"], "per_forward",
        other_shapes=strip(r for r in stage_rows if not r["per_forward"]),
        slice_serving=slice_res))
    kernels.append(kernel_entry(
        "dca_attn", dca_rows, seg_launches["dca_attn"], "per_step",
        per_crop_forward=SEG_CROP_FWD["dca_attn"]))
    kernels.append(kernel_entry(
        "mhsa", mhsa_rows, vit_launches["mhsa"], "per_step",
        vit_tiny_per_eval_forward=VIT_EVAL["mhsa"]))
    slopes = {f"{r['r']}x{r['c']}": r["us_per_pass"] for r in table["ew"]}
    for op in ew.OPS:
        # the slope table launches each shape alike: plain means over them
        rows = [r for r in ew_rows if r["name"] == f"ew_probe.{op}"]

        def mean(key):
            if rows[0][key] is None:
                return None
            return sum(r[key] for r in rows) / len(rows)
        kernels.append({
            "name": f"ew_probe.{op}", "route": "cuda",
            "source": PROBE_SRC + "ew_probe.cu",
            "replaces": "scripts/vpu_probe.py:59",
            "launches": table["launches"][f"ew_probe.{op}"],
            "max_abs_err": max(r["err_bf16"] for r in rows),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": mean("library_ms"), "shapes": strip(rows),
            "us_per_pass_per_tile": {shape: per[op]
                                     for shape, per in slopes.items()}})
    for name, (kernel, replaces) in CONSTRUCT_KERNELS.items():
        row = table[name]  # cli.probes' row: run, checked and timed there
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": PROBE_SRC + "constructs.cu", "replaces": replaces,
            "launches": table["launches"][kernel],
            "max_abs_err": row.get("err_vs_plain", row["err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row["library_ms"], "verdict": row["verdict"],
            "probe": {k: v for k, v in row.items()
                      if k not in ("ms", "plain_ms", "bound_ms",
                                   "library_ms", "verdict", "route",
                                   "launches")}})
    say("done", f"{time.time() - t_start:.0f} s")
    print(f"kernels: {json.dumps([k['name'] for k in kernels])}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
