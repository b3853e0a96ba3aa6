"""Hopper toolchain probes: counterpart of scripts/mosaic_probes.py, with
scripts/vpu_probe.py's per-op table (``--ew``).

The JAX suite re-checked, on each toolchain, the Mosaic constructs its
kernels work around and the A/B switches it measured once. Here each
construct probe (``probes/constructs.py``) runs its hand-written kernel in a
subprocess of its own (a device fault poisons the CUDA context, as a Mosaic
crash killed JAX's interpreter), holds it against its plain version and
prints keep / FLIP: "keep" when the port's current design choice still
holds. Then, unless ``--skip-perf``, the A/B rows of the port's switches,
each "keep" unless the alternative wins by more than 2 % (constructs.NOISE,
the run-to-run spread of device times):
  pb_s_stage    cli.kbench --s-stage at base stage 3 (18 blocks with CPEs):
                one s_stage launch against the default chain (F.conv2d +
                s_block per block); keep per-block unless s_stage wins
  pb_cpe        cli.kbench with and without --cpe-in-kernel at base stages 1
                and 3; keep the external CPE unless the in-kernel one wins
  pb_train_cpe  cli.train_kbench --cpe against --cpe-ext at stage 1 (grad
                ms); keep external unless the in-kernel CPE wins
  pb_train_paths  6 steps of cli.train (lemevit_tiny, vit_tiny) and
                cli.train_seg (lemevit_tiny, 512^2, B = 8), each with and
                without --train-cpe-in-kernel: img/s and peak GiB (host-
                paced, for the record); the verdict comes from the time
                the kernels of a bare train step of each take on the
                device (torch.profiler), the switch toggled on one model
                in alternating pairs (step_device_ms): keep external
                unless the switch's kernels are faster
  pb_ew         n/a: the port's kernels have no bf16-elementwise mode (the
                cast_rt cost of --ew stands beside it)
The result goes to ``--out`` (HOPPER_PROBES.json) and to stdout, with every
kernel launch the run made (``launches``).

  python -m lemevit_tpu_torch.cli.probes [--ew] [--skip-perf]
  python -m lemevit_tpu_torch.cli.probes --probe cluster   # one, in-process
  python -m lemevit_tpu_torch.cli.probes --device cpu --skip-perf

``--device cuda`` is the default and raises without CUDA. ``--device cpu``
runs the construct probes' plain versions only, labels every row "plain
(cpu)" and measures no time (the per-op table and the A/B rows read "not
measured"); a kernel row never falls back to its plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from lemevit_tpu_torch.probes import constructs, ew
from lemevit_tpu_torch.utils.profiling import cuda_ms, kernel_ms

REPO = Path(__file__).resolve().parents[2]
CONSTRUCT_PROBES = list(constructs.PROBES)
TRAIN_PATHS = ("lemevit_tiny", "vit_tiny", "train_seg")
PERF_PROBES = ("pb_s_stage", "pb_cpe", "pb_train_cpe", "pb_train_paths",
               "pb_ew")
TRAIN_STEPS = 6
TRAIN_BATCH = 64   # cli.train's batch in pb_train_paths
PLAIN_CPU = "plain (cpu)"
NOT_MEASURED = "not measured (plain (cpu))"   # device times, on the CPU


def run_construct_probe(name: str, device: str, timeout: int = 600) -> dict:
    """One construct probe in a subprocess: its row, or a failed row when
    the process died or printed none."""
    proc = subprocess.run(
        [sys.executable, "-m", "lemevit_tpu_torch.cli.probes", "--probe",
         name, "--device", device], cwd=REPO, capture_output=True,
        text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    try:
        row = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        tail = (proc.stderr or proc.stdout).strip()[-300:]
        return {"ok": False, "launches": {}, "verdict":
                f"FAIL: the probe's process exited {proc.returncode}: "
                f"{tail}"}
    if proc.returncode != 0:
        row["ok"] = False
    return row


def _keep(label_keep: str, label_flip: str, ours: float, other: float,
          unit: str = "ms") -> str:
    """JAX's wording: keep unless the alternative beats ``ours`` (the
    current default) by more than constructs.NOISE, the run-to-run spread
    of device times; ``unit`` "img/s" compares rates."""
    faster = (other * (1 + constructs.NOISE) < ours if unit == "ms"
              else other > ours * (1 + constructs.NOISE))
    if not faster:
        return f"keep {label_keep} ({ours:.3f} vs {other:.3f} {unit})"
    return (f"FLIP: {label_flip} now faster ({other:.3f} vs {ours:.3f} "
            f"{unit})")


def pb_s_stage(device, reps: int) -> dict:
    from lemevit_tpu_torch.cli import kbench
    rows = kbench.main(["--s-stage", "--stages", "3", "--reps", str(reps),
                        "--impls", "kernel", "--device", str(device)])
    t = {r["form"]: r["ms_stage"] for r in rows}
    return {"ms_stage": t, "verdict": _keep("per-block", "s_stage",
                                            t["chain"], t["s_stage"])}


def pb_cpe(device, reps: int) -> dict:
    from lemevit_tpu_torch.cli import kbench
    argv = ["--stages", "1,3", "--reps", str(reps), "--impls", "kernel",
            "--device", str(device)]
    ext, fused = kbench.main(argv), kbench.main(argv + ["--cpe-in-kernel"])
    out = {}
    for e, f in zip(ext, fused):
        out[f"stage{e['stage']}"] = {
            "ext_ms_block": e["ms_block"], "in_kernel_ms_block":
            f["ms_block"], "verdict": _keep(
                "external CPE", "in-kernel CPE", e["ms_block"],
                f["ms_block"])}
    return out


def pb_train_cpe(device, reps: int) -> dict:
    from lemevit_tpu_torch.cli import train_kbench
    argv = ["--stages", "1", "--reps", str(reps), "--impls", "kernel",
            "--device", str(device)]
    ext = train_kbench.main(argv + ["--cpe-ext"])[0]
    fused = train_kbench.main(argv + ["--cpe"])[0]
    return {"ext": {k: ext[k] for k in ("fwd_ms", "grad_ms")},
            "in_kernel": {k: fused[k] for k in ("fwd_ms", "grad_ms")},
            "verdict": _keep("external", "fused CPE", ext["grad_ms"],
                             fused["grad_ms"])}


def train_path(path: str, switch: bool) -> dict:
    """6 steps (and one eval) of a training path on synthetic data on the
    card, with or without --train-cpe-in-kernel: img/s over steps 2-6,
    ms/step, peak GiB allocated."""
    from lemevit_tpu_torch.cli import train, train_seg
    flags = ["--train-cpe-in-kernel"] if switch else []
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        if path == "train_seg":
            res = train_seg.main(["--synthetic", "--iters", str(TRAIN_STEPS),
                                  "--eval-interval", str(TRAIN_STEPS),
                                  "--output", out, *flags])
        else:
            res = train.main(["--synthetic", "--model", path, "--batch-size",
                              str(TRAIN_BATCH), "--config",
                              str(REPO / "configs" / "lemevit.yaml"),
                              "--epochs", "1", "--steps-per-epoch",
                              str(TRAIN_STEPS), "--output", out, *flags])
    return {"img_per_s": res["samples_per_sec"], "ms_per_step":
            res["step_ms"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _bare_step(path: str, device):
    """A training path's model and one bare bf16 train step on device-
    resident synthetic data (no loader, no mixup): (model, step), the
    shapes of its CLI's defaults."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.cli import train_seg
    from lemevit_tpu_torch.train.optim import (build_lr_schedule,
                                               build_optimizer)
    from lemevit_tpu_torch.train.state import ModelEma, TrainState
    from lemevit_tpu_torch.train.steps import train_step
    g = torch.Generator().manual_seed(5)
    if path == "train_seg":
        from lemevit_tpu_torch.tasks.upernet import create_upernet
        a = train_seg.build_parser().parse_args([])
        model = create_upernet(a.backbone, a.num_classes,
                               channels=a.channels, device=device, seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=0.0,
                                weight_decay=0.05)
        img = torch.randint(0, 256, (a.batch_size, a.crop_size, a.crop_size,
                                     3), generator=g,
                            dtype=torch.uint8).to(device)
        mask = torch.randint(0, a.num_classes, img.shape[:3],
                             generator=g).to(device)
        return model, lambda: train_seg.seg_train_step(
            model, opt, 1e-4, img, mask, autocast_dtype=torch.bfloat16)
    model = create_model(path, device=device, drop_path_rate=0.15)
    model.set_generator(torch.Generator(device=device).manual_seed(0))
    state = TrainState(model, build_optimizer(model), build_lr_schedule(),
                       ModelEma(model, 0.996))
    img = torch.randn(TRAIN_BATCH, 224, 224, 3, generator=g).to(device)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g).to(device)
    return model, lambda: train_step(state, img, labels,
                                     autocast_dtype=torch.bfloat16)


def step_device_ms(path: str, device, pairs: int = 3,
                   steps: int = 3) -> dict:
    """The device's time per bare train step of a training path with the
    CPE outside (the default) and inside the training kernels. The switch
    is toggled on one model's blocks, side by side in ``pairs`` alternating
    pairs, so drift falls on both sides alike; each side of a pair takes
    the elapsed time per step of ``steps`` back-to-back steps (cuda_ms,
    host gaps included: "elapsed_ms"), then the kernels' time of one
    profiled step (kernel_ms, no host gaps: "default_ms" / "switch_ms").
    None where the profiler recorded nothing."""
    from lemevit_tpu_torch.models.lemevit import LeMeBlock
    model, step = _bare_step(path, device)
    blocks = [m for m in model.modules() if isinstance(m, LeMeBlock)]
    kern = {False: [], True: []}
    elapsed = {False: [], True: []}
    for _ in range(pairs):
        for switch in (False, True):
            for blk in blocks:
                blk.train_cpe_in_kernel = switch
            elapsed[switch].append(cuda_ms(step, steps, warm=2))
            kern[switch].append(kernel_ms(step, warm=0))

    def mean(xs):
        return None if None in xs else sum(xs) / len(xs)
    return {"default_ms": mean(kern[False]), "switch_ms": mean(kern[True]),
            "pairs_ms": list(zip(kern[False], kern[True])),
            "elapsed_ms": {"default": mean(elapsed[False]),
                           "switch": mean(elapsed[True])}}


def train_path_row(default: dict, switch: dict, device_ms: dict) -> dict:
    """A training path's A/B row: the CLI runs' host-paced img/s and peak
    GiB beside the bare step's device ms (``step_device_ms``), which
    decides: keep the external CPE (the default) unless the switch's
    steps are faster."""
    if device_ms["default_ms"] is None or device_ms["switch_ms"] is None:
        verdict = "undecided: the profiler recorded no device time"
    else:
        verdict = _keep("external", "--train-cpe-in-kernel",
                        device_ms["default_ms"], device_ms["switch_ms"])
    return {"default": default, "train_cpe_in_kernel": switch,
            "step_device_ms": device_ms, "verdict": verdict}


def perf_rows(device, reps: int, train_paths: str, ew_rows=None) -> dict:
    """The A/B rows on the card; pb_ew carries the cast_rt cost of the
    per-op table ``ew_rows`` where --ew ran."""
    rows = {}
    for name, fn in (("pb_s_stage", pb_s_stage), ("pb_cpe", pb_cpe),
                     ("pb_train_cpe", pb_train_cpe)):
        rows[name] = fn(device, reps)
        print(f"{name:16s} {json.dumps(rows[name])}", flush=True)
    paths = [p for p in train_paths.split(",") if p != "none"]
    rows["pb_train_paths"] = {
        p: train_path_row(train_path(p, False), train_path(p, True),
                          step_device_ms(p, device)) for p in paths}
    for p, row in rows["pb_train_paths"].items():
        print(f"{'pb_train_paths':16s} {p}: {row['verdict']}", flush=True)
    rows["pb_ew"] = {
        "verdict": "n/a: the port's kernels have no bf16-elementwise mode",
        "cast_rt_us_per_pass_per_tile": (
            [r["us_per_pass"]["cast_rt"] for r in ew_rows]
            if ew_rows else "run --ew")}
    print(f"{'pb_ew':16s} {rows['pb_ew']['verdict']}", flush=True)
    return rows


def launch_counts() -> dict:
    """Every kernel launch this process made: the probes' and the model
    kernels' (the A/B rows run those)."""
    from lemevit_tpu_torch.attn import dca, fused_block, fused_train, mhsa
    counts = {}
    for c in (constructs.LAUNCHES, ew.LAUNCHES, fused_block.LAUNCHES,
              fused_train.LAUNCHES, dca.LAUNCHES, mhsa.LAUNCHES):
        counts.update({k: v for k, v in c.items() if v})
    return counts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--probe", default="", choices=[""] + CONSTRUCT_PROBES,
                   help="run one construct probe in this process")
    p.add_argument("--skip-perf", action="store_true",
                   help="the construct probes only, no A/B rows")
    p.add_argument("--ew", action="store_true",
                   help="the per-op cost table (scripts/vpu_probe.py)")
    p.add_argument("--train-paths", default=",".join(TRAIN_PATHS),
                   help="comma-separated training paths of pb_train_paths "
                        f"({', '.join(TRAIN_PATHS)}), or 'none'")
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--out", default="HOPPER_PROBES.json")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (plain versions only)")
    return p


def main(argv=None) -> dict:
    from lemevit_tpu_torch.models.registry import resolve_device
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.probe:
        row = constructs.PROBES[args.probe](device)
        row["launches"] = launch_counts()
        print(json.dumps(row), flush=True)
        if not row["ok"]:
            sys.exit(1)
        return row

    table = {}
    for name in CONSTRUCT_PROBES:
        table[name] = run_construct_probe(name, str(device))
        print(f"{name:16s} {table[name]['verdict']}", flush=True)
    if device.type != "cuda":  # no device times on the CPU
        if args.ew:
            table["ew"] = NOT_MEASURED
        if not args.skip_perf:
            table.update(dict.fromkeys(PERF_PROBES, NOT_MEASURED))
    else:
        if args.ew:
            table["ew"] = ew.slope_table(device, reps=args.reps)
            for row in table["ew"]:
                print(ew.format_row(row), flush=True)
        if not args.skip_perf:
            table.update(perf_rows(device, args.reps, args.train_paths,
                                   table.get("ew")))
    table["launches"] = launch_counts()
    for name in CONSTRUCT_PROBES:
        for k, v in table[name].get("launches", {}).items():
            table["launches"][k] = table["launches"].get(k, 0) + v
    table["device"] = (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else PLAIN_CPU)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(table), flush=True)
    return table


if __name__ == "__main__":
    main()
