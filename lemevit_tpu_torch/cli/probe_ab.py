"""The probe kernels of several checkouts of this repository, timed side by
side on one card: the A/B of a probe's redesign.

  python -m lemevit_tpu_torch.cli.probe_ab --roots old,.,.,old --out ab.json

Each root (a directory holding a checkout, e.g. an older commit unpacked by
``git archive``) is timed in turn, in a process of its own that imports that
root's ``lemevit_tpu_torch.probes``: it builds that root's probe library and
launches its kernels through its own wrappers, timed by this file's
harness, the same for every root:
  - ``ew_probe`` for every op at K = 1 and at vpu_probe's K, and the K = 0
    copy, on vpu_probe's three (R, C) tiles x 64, with ``ew.LIBRARY``'s
    call beside; from them the per-pass slope (t_K - t_0) / K / 64 in us
    per (R, C) tile, and per element; and a fingerprint of each output's
    bits, so that each root's outputs are compared with the first root's
    ("same_bits": how many of them agree);
  - the construct probes' kernels on their probes' inputs (erf, the
    scatter on the tap input, roll, fold) beside their library calls, and
    the erf, the roll and the fold also where the bytes set the pace
    ("erf_large": K = 1 on the slope input, the (256, 256) tile 64 times;
    "roll_large": (200704, 64) fp32 by the probe's 56 rows; "fold_large":
    (64, 784, 320) bf16), each with its bytes; fingerprints of the erf's
    (both forms, K = 1 and the slope's K, and the large input at K = 1),
    the roll's and the fold's (both sizes) outputs, compared with the
    first root's as the ew outputs are;
  - the erf probe's slopes (``erf_slopes``): each form at K = 1 and at
    constructs.ERF_SLOPE_K on the slope input, (t_K - t_1) / (K - 1) /
    64 in us per evaluation of one (256, 256) tile, as
    constructs.probe_erf_prim decides its verdict by;
  - the card's launch floor ("launch_floor_ms": the device time of a
    one-element fill).
Every call is timed by CUDA events over ``--reps`` warm calls ("ms", which
the host paces where the kernel is short) and by the profiler's device time
of its kernels ("device_ms": for a probe the kernels whose name holds its
kernel's, for a library call all of them). Alternate the roots (a / b / b /
a) so that drift falls on both alike. Runs on the card only: without CUDA a
root's process raises.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

TILES = 64   # vpu_probe's grid: a probe input is (R * 64, C)
# constructs.FOLD_X_LARGE and ROLL_X_LARGE, made here as constructs'
# fold_input and roll_input make them, so that a root whose package lacks
# them is timed on the same inputs
FOLD_LARGE = (64, 784, 320)
ROLL_LARGE = (200704, 64)


def _events_ms(fn, reps: int, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, name, iters: int = 20, warm: int = 3):
    """The profiler's device ms per call of the kernels whose name holds
    ``name`` (all kernels for None), each its mean times its launches per
    call (utils/profiling.py::kernel_ms's rule, copied so that every root
    is timed alike); None where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total / e.count * max(1, round(e.count / iters))
             for e in prof.key_averages()
             if e.device_time_total > 0
             and str(getattr(e, "device_type", "")).endswith("CUDA")
             and not getattr(e, "is_user_annotation", False)
             and (name is None or name in e.key))
    return us / 1e3 if us else None


def roll_large(device):
    """The large roll input: constructs.roll_input at ROLL_LARGE."""
    import torch
    return torch.arange(ROLL_LARGE[0] * ROLL_LARGE[1], dtype=torch.float32
                        ).reshape(ROLL_LARGE).to(device)


def _digest(t) -> str:
    """A fingerprint of a tensor's bits, to compare roots' outputs."""
    import torch
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha1(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def measure(reps: int) -> dict:
    """This process's root's probe kernels (see the module docstring)."""
    import torch
    from lemevit_tpu_torch.probes import constructs, ew
    dev = torch.device("cuda")

    def timed(fn, name):
        # the profiler may record nothing once: ask twice
        dev = _device_ms(fn, name)
        return {"ms": _events_ms(fn, reps),
                "device_ms": dev if dev is not None else _device_ms(fn, name)}
    out = {"ew": [], "constructs": {}}
    for r, c in ew.SHAPES:
        x = ew.probe_input(r, c, dev)
        row = {"r": r, "c": c, "k0": timed(lambda: ew.ew_probe(x, "fma", 0),
                                           "k_ew_probe"), "ops": {}}
        for op in ew.OPS:
            k = ew.jax_k(op)
            entry = {"k": k, "k1": timed(lambda: ew.ew_probe(x, op, 1),
                                         "k_ew_probe"),
                     "kj": timed(lambda: ew.ew_probe(x, op, k),
                                 "k_ew_probe"),
                     "bits": [_digest(ew.ew_probe(x, op, kk))
                              for kk in (1, k)]}
            lib = ew.LIBRARY.get(op)
            if lib is not None:
                entry["library"] = timed(lambda: lib(x), None)
            row["ops"][op] = entry
        out["ew"].append(row)
    ci = constructs

    def probe(kernel, name, library, nbytes):
        return {"kernel": timed(kernel, name), "library": timed(library, None),
                "bytes": nbytes}
    xe = ci.erf_input(dev)
    xes = xe.repeat(ci.ERF_TILES, 1)   # the slope input
    for key, xi in (("erf", xe), ("erf_large", xes)):
        out["constructs"][key] = probe(lambda: ci.erf_probe(xi),
                                       "k_erf_probe", lambda: torch.erf(xi),
                                       2 * xi.numel() * 4)
    k = ci.ERF_SLOPE_K
    out["erf_slope"] = {"k": k, "tiles": ci.ERF_TILES, **{
        form: {f"k{kk}": timed(lambda: ci.erf_probe(xes, poly, kk),
                               "k_erf_probe") for kk in (1, k)}
        for form, poly in (("erff", False), ("poly", True))}}
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(ci.TAP_ROWS, ci.TAP_CH, generator=g).to(dev)
    zeros = torch.zeros(ci.TAP_ROWS, dtype=torch.int32, device=dev)
    into = torch.zeros(1, ci.TAP_CH, device=dev)
    out["constructs"]["scatter"] = {
        "kernel": timed(lambda: ci.scatter_add_probe(xs, zeros, 1),
                        "k_scatter_add_probe"),
        "library": timed(lambda: into.index_add_(0, zeros, xs), None)}
    xr = ci.roll_input(dev)
    xrl = roll_large(dev)
    for key, xi in (("roll", xr), ("roll_large", xrl)):
        out["constructs"][key] = probe(
            lambda: ci.roll_rows_probe(xi, ci.ROLL_SHIFT),
            "k_roll_rows_probe", lambda: torch.roll(xi, ci.ROLL_SHIFT, 0),
            2 * xi.numel() * 4)
    xf = ci.fold_input(dev)
    g = torch.Generator().manual_seed(0)
    xl = torch.randn(FOLD_LARGE, generator=g).to(torch.bfloat16).to(dev)
    for key, xi in (("fold", xf), ("fold_large", xl)):
        out["constructs"][key] = probe(
            lambda: ci.fold_probe(xi), "k_fold_probe",
            lambda: xi.reshape(-1, xi.shape[2]).clone(), 2 * xi.numel() * 2)
    z = torch.zeros(1, device=dev)
    out["launch_floor_ms"] = _device_ms(z.zero_, None)
    out["construct_bits"] = {
        **{f"erf.{form}.k{kk}": _digest(ci.erf_probe(xe, poly, kk))
           for form, poly in (("erff", False), ("poly", True))
           for kk in (1, k)},
        "erf_large.erff.k1": _digest(ci.erf_probe(xes)),
        "roll": _digest(ci.roll_rows_probe(xr, ci.ROLL_SHIFT)),
        "roll_large": _digest(ci.roll_rows_probe(xrl, ci.ROLL_SHIFT)),
        "fold": _digest(ci.fold_probe(xf)),
        "fold_large": _digest(ci.fold_probe(xl))}
    return out


def slopes(row: dict) -> dict:
    """Per op of one tile's row: the per-pass us per (R, C) tile, (t_K -
    t_0) / K / 64, by events ("us_per_pass") and device time
    ("us_per_pass_device"), and the device slope per element in ps
    ("ps_per_element")."""
    out = {}
    n = row["r"] * TILES * row["c"]
    for op, e in row["ops"].items():
        ev = (e["kj"]["ms"] - row["k0"]["ms"]) / e["k"] / TILES * 1e3
        dv = None
        if e["kj"]["device_ms"] is not None and row["k0"]["device_ms"]:
            dv = ((e["kj"]["device_ms"] - row["k0"]["device_ms"]) / e["k"]
                  / TILES * 1e3)
        out[op] = {"us_per_pass": ev, "us_per_pass_device": dv,
                   "ps_per_element": None if dv is None
                   else dv * TILES / n * 1e6}
    return out


def erf_slopes(slope: dict) -> dict:
    """Per erf form of one run's ``erf_slope``: us per evaluation of one
    (256, 256) tile, (t_K - t_1) / (K - 1) / tiles, by events
    ("us_per_tile") and device time ("us_per_tile_device", None where the
    profiler recorded nothing)."""
    k, tiles, out = slope["k"], slope["tiles"], {}
    for form in ("erff", "poly"):
        t1, tk = slope[form]["k1"], slope[form][f"k{k}"]
        dv = None
        if t1["device_ms"] is not None and tk["device_ms"] is not None:
            dv = (tk["device_ms"] - t1["device_ms"]) / (k - 1) / tiles * 1e3
        out[form] = {"us_per_tile": (tk["ms"] - t1["ms"]) / (k - 1) / tiles
                     * 1e3, "us_per_tile_device": dv}
    return out


def report(runs: list) -> list:
    """Lines of the A/B table: per tile and op the K = 1 device ms of each
    run (a, b, ...), the library call's (the first run's), and the device
    slope per element in ps; per construct probe, kernel and library
    device ms beside its bytes bound; the launch floor."""
    from lemevit_tpu_torch.utils.profiling import HBM_BYTES_PER_S

    def f(xs):
        return " ".join("-" if x is None else f"{x:.4g}" for x in xs)
    lines = [f"runs {', '.join(r['root'] for r in runs)} on "
             f"{runs[0]['card']}"]
    for ti, row in enumerate(runs[0]["ew"]):
        tiles = [r["ew"][ti] for r in runs]
        n = row["r"] * TILES * row["c"]
        lines.append(f"tile ({row['r']}*64, {row['c']}): bytes bound "
                     f"{4 * n / HBM_BYTES_PER_S * 1e3:.4f} ms; K=0 device "
                     f"{f(t['k0']['device_ms'] for t in tiles)}")
        for op, e in row["ops"].items():
            k1 = f(t["ops"][op]["k1"]["device_ms"] for t in tiles)
            ps = f(t["slopes"][op]["ps_per_element"] for t in tiles)
            lib = f([e.get("library", {}).get("device_ms")])
            lines.append(f"  {op:10s} K=1 {k1} | library {lib} | "
                         f"ps/element {ps}")
    for name, first in runs[0]["constructs"].items():
        got = [r["constructs"][name] for r in runs]
        bound = first.get("bytes", 0) / HBM_BYTES_PER_S * 1e3
        lines.append(f"{name:10s} kernel "
                     f"{f(g['kernel']['device_ms'] for g in got)} | library "
                     f"{f(g['library']['device_ms'] for g in got)} | bytes "
                     f"bound {bound:.5f}")
    for form in ("erff", "poly"):
        got = [erf_slopes(r["erf_slope"])[form] for r in runs]
        lines.append(f"erf slope {form}: us per tile per evaluation, "
                     f"device {f(g['us_per_tile_device'] for g in got)} | "
                     f"events {f(g['us_per_tile'] for g in got)}")
    lines.append("launch floor (device) "
                 f"{f(r.get('launch_floor_ms') for r in runs)}")
    return lines


def run_root(root: Path, reps: int) -> dict:
    """``measure`` in a process of its own that imports root's package."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--measure",
         "--reps", str(reps)], cwd=root, env=env, capture_output=True,
        text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"probe_ab {root}: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--roots", default=".",
                   help="comma-separated checkout roots, timed in order")
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--out", default="PROBE_AB.json")
    p.add_argument("--measure", action="store_true",
                   help="time this process's own root (one run)")
    args = p.parse_args(argv)
    if args.measure:
        sys.path[0] = os.getcwd()  # the root's package, not this directory
        print(json.dumps(measure(args.reps)), flush=True)
        return []
    roots, runs = args.roots.split(","), []
    for label in roots:
        res = run_root(Path(label).resolve(), args.reps)
        res.update(root=label, card=card())
        for row in res["ew"]:
            row["slopes"] = slopes(row)
        res["bits"] = {f"{r['r']}x{r['c']}.{op}": e["bits"]
                       for r in res["ew"] for op, e in r["ops"].items()}
        res["bits"].update(res["construct_bits"])
        first = (runs[0] if runs else res)["bits"]
        res["differ"] = [k for k, v in first.items() if res["bits"][k] != v]
        res["same_bits"] = (
            f"{len(first) - len(res['differ'])} of {len(first)} outputs "
            f"((tile, op) at K = 1 and vpu_probe's K; the erf's, the "
            f"roll's and the fold's) bit for bit as {roots[0]}'s")
        runs.append(res)
        print(json.dumps({"root": label, "card": res["card"],
                          "same_bits": res["same_bits"],
                          "differ": res["differ"],
                          "launch_floor_ms": res["launch_floor_ms"],
                          "erf_slopes": erf_slopes(res["erf_slope"]), "ew": [
            {"tile": f"{r['r']}x{r['c']}", "k1_device_ms": {
                op: e["k1"]["device_ms"] for op, e in r["ops"].items()}}
            for r in res["ew"]], "constructs": res["constructs"]}),
            flush=True)
    print("\n".join(report(runs)), flush=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    return runs


if __name__ == "__main__":
    main()
