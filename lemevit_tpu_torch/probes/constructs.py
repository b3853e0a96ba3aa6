"""The construct probes, counterparts of the four Mosaic probes of
``scripts/mosaic_probes.py``. A Mosaic probe compiled one Pallas construct
that had crashed the TPU compiler, to see whether the workaround in the JAX
kernels was still needed. On Hopper the question is which CUDA construct the
port's kernels may rely on; each probe runs its kernel
(``probes/csrc/constructs.cu``), holds it against its plain version and
prints a verdict: "keep" when the port's current design choice still holds,
"FLIP" when the measurement says it should be revisited.

  erf_prim      ``erf_probe``: device ``erff`` against JAX's degree-29
                polynomial (``pallas_block._erf``, the TPU's workaround) on
                JAX's (256, 256) linspace(-3, 3) tile; keep (the port's
                GELU stays on ``erff``) when erff is within 1e-6 of the
                fp64 erf and no slower than the polynomial (within the
                ``NOISE`` of device times) per evaluation.
  scatter       ``scatter_add_probe``: an atomicAdd scatter of JAX's input
                ((128, 128) ones into rows arange(128) % 8; exact), then
                seeded fp32 at the CPE tap-gradient reduction's size
                (3136 * 64 rows into 64 channels) twice; keep (the
                fixed-order fp32 partials of k_wgrad / k_cpe_grads_reduce)
                when the two runs differ in any bit.
  pltpu_roll    ``roll_rows_probe``: (3136, 64) fp32 shifted by 56 flat
                rows (one image row of stage 0) with 16-byte loads,
                wrapping as jnp.roll; keep when exact.
  reshape_c320  ``fold_probe``: (4, 784, 320) bf16 copied into (3136, 320)
                through the folded index with 16-byte loads (640-byte
                rows); keep (in the port the fold is a view) when exact.
  cluster       ``cluster_probe``: clusters of 1, 2, 4, 8 and 16 CTAs (16
                with the non-portable opt-in), each CTA reading its peers'
                ranks from global and distributed shared memory after the
                cluster barrier; keep (s_stage's cap of 8) when 16 does not
                launch.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs its ``*_plain`` version. ``LAUNCHES`` counts the kernels'
launches. ``PROBES[name](device)`` runs one probe and returns its result
row; on the CPU it runs the plain versions only, and the row says so.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lemevit_tpu_torch import probes
from lemevit_tpu_torch.utils.profiling import HBM_BYTES_PER_S, cuda_ms

LAUNCHES = {"erf_probe": 0, "scatter_add_probe": 0, "roll_rows_probe": 0,
            "fold_probe": 0, "cluster_probe": 0}
# lemevit_tpu/attn/pallas_block.py:73-95: erf(x) = x P(2 x^2 / B^2 - 1) on
# x clamped to [-B, B]
ERF_B = 3.925
ERF_P = (3.6027794364e-01, -1.7988466805e-01, 1.3393152019e-01,
         -1.0907175299e-01, 9.0606976620e-02, -7.4288916019e-02,
         5.8309038237e-02, -4.2462337431e-02, 3.0498341857e-02,
         -2.3130013672e-02, 1.3295609324e-02, -3.5220870811e-03,
         2.7808746265e-03, -4.4408601711e-03, 1.8774974659e-03)
ERF_TILE = (256, 256)
ERF_TOL = 1e-6           # the verdict's limit on erff's error
ERF_SLOPE_K = 33         # evaluations per element of the timed call
ERF_TILES = 64           # the timed array: JAX's tile 64 times (vpu_probe)
NOISE = 0.02             # device times closer than this decide no verdict
SCATTER_X = (128, 128)   # JAX's scatter input, rows into arange % 8
SCATTER_BINS = 8
TAP_ROWS, TAP_CH = 3136 * 64, 64   # k_cpe_tap_grads' rows at stage 0
ROLL_X, ROLL_SHIFT = (3136, 64), 56
FOLD_X = (4, 784, 320)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTERS = 16            # clusters per probe launch


# ---------------------------------------------------------------- plain


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """The port's copy of JAX's polynomial erf (pallas_block._erf)."""
    xc = x.clamp(-ERF_B, ERF_B)
    s = xc * xc * (2.0 / (ERF_B * ERF_B)) - 1.0
    acc = torch.full_like(x, ERF_P[-1])
    for coef in ERF_P[-2::-1]:
        acc = acc * s + coef
    return xc * acc


def erf_probe_plain(x, poly: bool = False, k: int = 1) -> torch.Tensor:
    """The sum over p < k of erf(x (1 + p / 1024)) (torch.erf, or
    ``erf_poly``) in fp32: erf(x) at k = 1."""
    x = x.float()
    acc = torch.zeros_like(x)
    for p in range(k):
        t = x * (1.0 + p * (1.0 / 1024.0))
        acc = acc + (erf_poly(t) if poly else torch.erf(t))
    return acc


def scatter_add_probe_plain(x, idx, out_rows: int) -> torch.Tensor:
    """out[idx[r]] += x[r] into zeros (out_rows, C)."""
    out = torch.zeros(out_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx.long(), x)


def roll_rows_probe_plain(x, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, 0)


def fold_probe_plain(x) -> torch.Tensor:
    r, n, c = x.shape
    return x.reshape(r * n, c).clone()


def cluster_probe_plain(csize: int, clusters: int) -> torch.Tensor:
    """What k_cluster_probe writes: per CTA its rank, then every peer's
    rank twice (read from global and from shared memory)."""
    ranks = np.arange(csize, dtype=np.int32)
    row = lambda r: np.concatenate([[r], ranks, ranks])
    return torch.from_numpy(np.tile(np.stack([row(r) for r in ranks]),
                                    (clusters, 1)).reshape(-1))


# ---------------------------------------------------------------- CUDA


def erf_probe(x, poly: bool = False, k: int = 1) -> torch.Tensor:
    """``erf_probe_plain`` on fp32 x: ``k_erf_probe<poly>``."""
    if not x.is_cuda:
        return erf_probe_plain(x, poly, k)
    probes.check_cuda("erf_probe", x, dtype=torch.float32)
    if k < 1:
        raise ValueError(f"erf_probe: k={k}; at least one evaluation")
    out = torch.empty_like(x)
    probes.launch("erf_probe", x, int(poly), k, x, out, x.numel(),
                  counts=LAUNCHES)
    return out


def scatter_add_probe(x, idx, out_rows: int) -> torch.Tensor:
    """out[idx[r]] += x[r] by atomicAdd: ``k_scatter_add_probe``."""
    if not x.is_cuda:
        return scatter_add_probe_plain(x, idx, out_rows)
    probes.check_cuda("scatter_add_probe", x, dtype=torch.float32)
    probes.check_cuda("scatter_add_probe", idx, dtype=torch.int32)
    if x.dim() != 2 or idx.shape != (x.shape[0],) or idx.device != x.device:
        raise ValueError("scatter_add_probe: x (rows, C) and idx (rows,) on "
                         "one device expected")
    if int(idx.min()) < 0 or int(idx.max()) >= out_rows:
        raise ValueError("scatter_add_probe: an index is out of range")
    out = torch.zeros(out_rows, x.shape[1], dtype=x.dtype, device=x.device)
    probes.launch("scatter_add_probe", x, x, idx, out, x.shape[0],
                  x.shape[1], counts=LAUNCHES)
    return out


def roll_rows_probe(x, shift: int) -> torch.Tensor:
    """torch.roll(x, shift, 0) by 16-byte loads: ``k_roll_rows_probe``."""
    if not x.is_cuda:
        return roll_rows_probe_plain(x, shift)
    probes.check_cuda("roll_rows_probe", x, dtype=torch.float32)
    if x.dim() != 2 or x.shape[1] % 4:
        raise ValueError("roll_rows_probe: (rows, C) with C a multiple of 4 "
                         f"expected, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    probes.launch("roll_rows_probe", x, x, out, x.shape[0], x.shape[1],
                  shift, counts=LAUNCHES)
    return out


def fold_probe(x) -> torch.Tensor:
    """(R, N, C) -> (R * N, C) through the folded index: ``k_fold_probe``."""
    if not x.is_cuda:
        return fold_probe_plain(x)
    probes.check_cuda("fold_probe", x, dtype=torch.bfloat16)
    if x.dim() != 3 or x.shape[2] % 8:
        raise ValueError("fold_probe: (R, N, C) with C a multiple of 8 "
                         f"expected, got {tuple(x.shape)}")
    r, n, c = x.shape
    out = torch.empty(r * n, c, dtype=x.dtype, device=x.device)
    probes.launch("fold_probe", x, x, out, r, n, c, counts=LAUNCHES)
    return out


def cluster_probe(csize: int, clusters: int, device) -> torch.Tensor:
    """k_cluster_probe in clusters of csize CTAs on ``device``; raises if
    the launch is refused. A CPU device gives the plain version."""
    device = torch.device(device)
    if device.type != "cuda":
        return cluster_probe_plain(csize, clusters)
    out = torch.full((clusters * csize * (1 + 2 * csize),), -1,
                     dtype=torch.int32, device=device)
    probes.launch("cluster_probe", out, csize, clusters, out,
                  counts=LAUNCHES)
    return out


def cluster_occupancy(csize: int, device) -> int:
    """cudaOccupancyMaxActiveClusters of k_cluster_probe's clusters of
    csize CTAs (0 where the card cannot place one)."""
    lib = probes.library()
    active = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        lib.lm_cluster_occupancy(csize, ctypes.byref(active))
    return active.value


# ---------------------------------------------------------------- probes


def erf_input(device) -> torch.Tensor:
    """JAX's erf tile: linspace(-3, 3) over (256, 256), fp32."""
    n = ERF_TILE[0] * ERF_TILE[1]
    return torch.linspace(-3, 3, n, dtype=torch.float32).reshape(
        ERF_TILE).to(device)


def scatter_input(device):
    """JAX's scatter input: (128, 128) ones, rows into arange(128) % 8."""
    x = torch.ones(SCATTER_X, dtype=torch.float32, device=device)
    idx = (torch.arange(SCATTER_X[0], dtype=torch.int32) % SCATTER_BINS)
    return x, idx.to(device)


def roll_input(device) -> torch.Tensor:
    """(3136, 64) fp32 whose every element differs (its flat index)."""
    return torch.arange(ROLL_X[0] * ROLL_X[1], dtype=torch.float32).reshape(
        ROLL_X).to(device)


def fold_input(device) -> torch.Tensor:
    """(4, 784, 320) bf16, seeded."""
    g = torch.Generator().manual_seed(0)
    return torch.randn(FOLD_X, generator=g).to(torch.bfloat16).to(device)


def _times(device, kernel, plain, library=None, nbytes=0) -> dict:
    """The kernel's, the plain version's and the library call's device ms
    and the bytes bound on the card; "not measured" on the CPU."""
    if torch.device(device).type != "cuda":
        return {k: "not measured"
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": None if library is None else cuda_ms(
                library),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def _label(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "plain (cpu)"


def _verdict(route: str, keep: bool, keep_msg: str, flip_msg: str) -> str:
    """keep / FLIP on the card; on the CPU the plain versions decide
    nothing about the card."""
    if route != "cuda":
        return "plain (cpu)"
    return f"keep: {keep_msg}" if keep else f"FLIP: {flip_msg}"


def probe_erf_prim(device) -> dict:
    x = erf_input(device)
    exact = torch.erf(x.double())
    got, poly = erf_probe(x), erf_probe(x, poly=True)
    err = (got.double() - exact).abs().max().item()
    err_poly = (poly.double() - exact).abs().max().item()
    route = _label(device)
    # the timed form too: ERF_SLOPE_K evaluations summed per element
    err_k = max((erf_probe(x, pf, ERF_SLOPE_K) - erf_probe_plain(
        x, pf, ERF_SLOPE_K)).abs().max().item() / ERF_SLOPE_K
        for pf in (False, True))
    row = {"route": route, "err": err, "err_poly": err_poly,
           "err_vs_plain": max(
               (got - erf_probe_plain(x)).abs().max().item(),
               (poly - erf_probe_plain(x, poly=True)).abs().max().item(),
               err_k)}
    row.update(_times(device, lambda: erf_probe(x),
                      lambda: erf_probe_plain(x), lambda: torch.erf(x),
                      2 * x.numel() * 4))
    faster = True
    if route == "cuda":
        # us per evaluation over one (256, 256) tile: the slope over k on
        # the tile repeated ERF_TILES times (enough threads to fill the
        # card), as vpu_probe times its ops
        xs = x.repeat(ERF_TILES, 1)
        for name, poly_form in (("erff", False), ("poly", True)):
            t1, tk = (cuda_ms(lambda: erf_probe(xs, poly_form, k))
                      for k in (1, ERF_SLOPE_K))
            row[f"{name}_us_per_tile"] = ((tk - t1) / (ERF_SLOPE_K - 1)
                                          / ERF_TILES * 1e3)
        faster = (row["erff_us_per_tile"]
                  <= (1 + NOISE) * row["poly_us_per_tile"])
    row["ok"] = err <= ERF_TOL and row["err_vs_plain"] <= ERF_TOL
    speed = ("" if route != "cuda" else
             f"; {row['erff_us_per_tile']:.4f} against "
             f"{row['poly_us_per_tile']:.4f} us per evaluation per tile")
    row["verdict"] = _verdict(
        route, err <= ERF_TOL and faster,
        f"the GELU's erf stays on erff (err {err:.2e}, the polynomial's "
        f"{err_poly:.2e}{speed})",
        f"erff (err {err:.2e}, limit {ERF_TOL:g}) against JAX's polynomial "
        f"({err_poly:.2e}){speed}: re-measure the GELU's erf")
    return row


def probe_scatter(device) -> dict:
    x, idx = scatter_input(device)
    got = scatter_add_probe(x, idx, SCATTER_X[0])
    want = torch.zeros_like(got)
    want[:SCATTER_BINS] = SCATTER_X[0] // SCATTER_BINS
    exact = bool(torch.equal(got, want))
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(TAP_ROWS, TAP_CH, generator=g).to(device)
    zeros = torch.zeros(TAP_ROWS, dtype=torch.int32, device=device)
    a = scatter_add_probe(xs, zeros, 1)
    b = scatter_add_probe(xs, zeros, 1)
    ref = xs.double().sum(0, keepdim=True)
    # fp32 sums of 200704 terms in any order: within 1e-6 of sum |x|
    tol = 1e-6 * xs.abs().double().sum(0, keepdim=True)
    err = ((a.double() - ref).abs() / tol).max().item()
    same = bool(torch.equal(a, b))
    route = _label(device)
    row = {"route": route, "exact_jax_input": exact,
           "tap_sum_err_over_tol": err, "two_runs_bitwise_equal": same,
           "err": (got - scatter_add_probe_plain(x, idx, SCATTER_X[0])
                   ).abs().max().item()}
    row.update(_times(
        device, lambda: scatter_add_probe(xs, zeros, 1),
        lambda: scatter_add_probe_plain(xs, zeros, 1),
        lambda: torch.zeros(1, TAP_CH, device=xs.device).index_add_(
            0, zeros, xs), (xs.numel() + TAP_ROWS + TAP_CH) * 4))
    row["ok"] = exact and err <= 1.0
    row["verdict"] = _verdict(
        route, not same,
        "fixed-order fp32 partials (atomicAdd sums differ between runs)",
        "two atomicAdd runs agreed bit for bit: re-measure atomics against "
        "the fixed-order partials")
    return row


def probe_pltpu_roll(device) -> dict:
    x = roll_input(device)
    got = roll_rows_probe(x, ROLL_SHIFT)
    exact = bool(torch.equal(got, torch.roll(x, ROLL_SHIFT, 0)))
    row = {"route": _label(device), "exact": exact,
           "err": (got - roll_rows_probe_plain(x, ROLL_SHIFT)
                   ).abs().max().item()}
    row.update(_times(device, lambda: roll_rows_probe(x, ROLL_SHIFT),
                      lambda: roll_rows_probe_plain(x, ROLL_SHIFT),
                      lambda: torch.roll(x, ROLL_SHIFT, 0),
                      2 * x.numel() * 4))
    row["ok"] = exact
    row["verdict"] = _verdict(
        row["route"], exact,
        "16-byte row-shifted loads are exact (k_cpe_rows' access)",
        "the row-shifted loads disagree with torch.roll")
    return row


def probe_reshape_c320(device) -> dict:
    x = fold_input(device)
    got = fold_probe(x)
    exact = bool(torch.equal(got, x.reshape(-1, FOLD_X[2])))
    row = {"route": _label(device), "exact": exact,
           "err": (got.float() - fold_probe_plain(x).float()
                   ).abs().max().item()}
    # the library call is the plain version's one copy of the view
    row.update(_times(device, lambda: fold_probe(x),
                      lambda: fold_probe_plain(x),
                      lambda: x.reshape(-1, FOLD_X[2]).clone(),
                      2 * x.numel() * 2))
    row["ok"] = exact
    row["verdict"] = _verdict(
        row["route"], exact,
        "the fold is a view; 16-byte loads stay aligned at C=320",
        "the folded copy at C=320 is not exact")
    return row


def probe_cluster(device) -> dict:
    route = _label(device)
    sizes = {}
    for cs in CLUSTER_SIZES:
        want = cluster_probe_plain(cs, CLUSTERS)
        entry = {}
        if route == "cuda":
            entry["max_active_clusters"] = cluster_occupancy(cs, device)
            try:
                got = cluster_probe(cs, CLUSTERS, device)
                torch.cuda.synchronize(device)
            except RuntimeError as e:  # a refused launch is the data point
                entry.update(launched=False, error=str(e)[:200])
                sizes[cs] = entry
                continue
            entry.update(launched=True,
                         correct=bool(torch.equal(got.cpu(), want)),
                         err=(got.cpu() - want).abs().max().item(),
                         ms=cuda_ms(lambda: cluster_probe(
                             cs, CLUSTERS, device)))
        else:
            entry.update(launched="not measured",
                         correct=bool(torch.equal(
                             cluster_probe(cs, CLUSTERS, device), want)))
        sizes[cs] = entry
    wide = sizes[16].get("launched") is True
    row = {"route": route, "sizes": sizes,
           "err": max(e.get("err", 0) for e in sizes.values()),
           "ok": all(sizes[cs].get("correct", False) for cs in (1, 2, 4, 8))
           and (not wide or sizes[16]["correct"])}
    if route != "cuda":
        row["verdict"] = "plain (cpu)"
        return row
    # the bytes bound: every CTA writes 1 + 2 csize ranks, at csize 8
    row.update(ms=sizes[8]["ms"], library_ms=None,
               plain_ms=cuda_ms(lambda: cluster_probe_plain(
                   8, CLUSTERS).to(device)),
               bound_ms=4 * CLUSTERS * 8 * 17 / HBM_BYTES_PER_S * 1e3)
    row["verdict"] = _verdict(
        route, not wide,
        "clusters of 16 do not launch; s_stage's cap of 8 holds",
        f"a cluster of 16 launches ({sizes[16]['max_active_clusters']} "
        "active at once): s_stage's cap of 8 may be re-measured")
    return row


PROBES = {"erf_prim": probe_erf_prim, "scatter": probe_scatter,
          "pltpu_roll": probe_pltpu_roll,
          "reshape_c320": probe_reshape_c320, "cluster": probe_cluster}
