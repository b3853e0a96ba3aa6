"""Profiling, timing and model summary: counterpart of
lemevit_tpu/utils/profiling.py.

  - trace(): torch.profiler (host and CUDA activity) into a directory, as a
    Chrome trace (chrome://tracing, Perfetto)
  - StepTimer: host timing of step windows, synchronising the device at the
    end of each, so a window covers the device's work
  - cuda_ms(): the device time of a call, by CUDA events over warm calls
  - kernel_ms(): the time a call's CUDA kernels take on the device, by
    torch.profiler (no host gaps)
  - HBM_BYTES_PER_S, BF16_FLOPS, FP32_FLOPS: the H100 SXM's rates, for the
    least time a piece of work could take on the card (its bound)
  - cost_analysis(): multiply-adds of one forward by
    torch.utils.flop_counter (the JAX package reads XLA's cost analysis)
  - model_summary(): parameter table grouped by module path prefix
  - versions(): torch, CUDA, nvcc and the card's name
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, List, Optional

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code (CPU and, where present, CUDA activity)
    and write ``trace.json`` to ``log_dir``. Yields the profiler, whose
    ``key_averages()`` gives the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Host timing of step windows: ``start()`` opens a window, ``stop()``
    synchronises ``device`` (when it is a CUDA device) and closes it."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1000 * sum(self.times) / len(self.times) if self.times else 0.0


def cuda_ms(fn, iters: int = 30, warm: int = 3) -> float:
    """Mean device time in ms of fn() over ``iters`` back-to-back calls
    (CUDA events on the current device, after ``warm`` calls)."""
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


def kernel_ms(fn, iters: int = 1, warm: int = 1,
              name: Optional[str] = None) -> Optional[float]:
    """Mean time per call of fn()'s CUDA kernels on the device, summed by
    torch.profiler over ``iters`` calls after ``warm``: the device's work
    without the gaps where it waits for the host. Only device activity is
    recorded (host operators would multiply the profiler's cost); with
    ``name``, only the kernels whose name holds it. Each kernel counts its
    mean time times its launches per call (its records over ``iters``,
    rounded, at least one: fn launches the same kernels every call), so
    records the profiler drops do not shorten the call.
    None when the profiler records no such device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # device activity only; a user annotation's range on the device spans
    # kernels counted already
    us = sum(e.device_time_total / e.count * max(1, round(e.count / iters))
             for e in prof.key_averages()
             if e.device_time_total > 0
             and str(getattr(e, "device_type", "")).endswith("CUDA")
             and not getattr(e, "is_user_annotation", False)
             and (name is None or name in e.key))
    return us / 1e3 if us else None


def cost_analysis(model, img_size: int, device=None,
                  dtype: torch.dtype = torch.float32) -> Dict[str, float]:
    """Operations of one image's forward: {"flops", "gmacs"}, counted by
    torch.utils.flop_counter over the matrix products and convolutions. The
    model runs in eval mode with autograd on and every block and attention
    module on the plain composition (attn_backend "torch": the kernels are
    opaque to the counter); its mode and backends are restored after."""
    from torch.utils.flop_counter import FlopCounterMode

    from lemevit_tpu_torch.models.lemevit import LeMeBlock
    if device is None:
        device = next(model.parameters()).device
    x = torch.zeros(1, img_size, img_size, 3, device=device, dtype=dtype)
    was_training = model.training
    blocks = [m for m in model.modules() if isinstance(m, LeMeBlock)]
    backends = [blk.attn_backend for blk in blocks]
    model.eval()
    try:
        for blk in blocks:
            blk.attn_backend = "torch"
        with FlopCounterMode(display=False) as fc:
            model(x)
    finally:
        model.train(was_training)
        for blk, backend in zip(blocks, backends):
            blk.attn_backend = backend
    flops = float(fc.get_total_flops())
    return {"flops": flops, "gmacs": flops / 2e9}


def model_summary(model, max_depth: int = 2) -> str:
    """Parameter-count table grouped by the first ``max_depth`` parts of
    each parameter's module path."""
    rows: Dict[str, int] = {}
    total = 0
    for name, p in model.named_parameters():
        prefix = ".".join(name.split(".")[:max_depth])
        rows[prefix] = rows.get(prefix, 0) + p.numel()
        total += p.numel()
    width = max((len(k) for k in rows), default=10) + 2
    lines = [f"{'module':<{width}}params", "-" * (width + 10)]
    for k in sorted(rows):
        lines.append(f"{k:<{width}}{rows[k]:,}")
    lines.append("-" * (width + 10))
    lines.append(f"{'TOTAL':<{width}}{total:,} ({total / 1e6:.2f} M)")
    return "\n".join(lines)


def versions() -> Dict[str, str]:
    """torch, its CUDA, nvcc's release (what builds attn/csrc) and the
    cards, or "not found" / "none" where absent."""
    from lemevit_tpu_torch.attn import _build
    info = {"torch": torch.__version__,
            "cuda": torch.version.cuda or "none"}
    try:
        out = subprocess.run([_build.find_nvcc(), "--version"],
                             capture_output=True, text=True, timeout=30)
        info["nvcc"] = out.stdout.strip().splitlines()[-1]
    except (RuntimeError, OSError, subprocess.SubprocessError, IndexError):
        info["nvcc"] = "not found"
    info["devices"] = (", ".join(torch.cuda.get_device_name(i) for i in
                                 range(torch.cuda.device_count()))
                       if torch.cuda.is_available() else "none")
    return info
