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
                JAX's (256, 256) linspace(-3, 3) tile, a float4 a thread
                (``erf_plan``); keep (the port's GELU stays on ``erff``)
                when erff is within 1e-6 of the fp64 erf and no slower than
                the polynomial (within the ``NOISE`` of device times) per
                evaluation.
  scatter       ``scatter_add_probe``: a scatter whose per-CTA partials
                (runs of equal index summed in registers, then a shared-
                memory partial where ``scatter_plan`` fits it) meet by
                global atomicAdd, on JAX's input ((128, 128) ones into rows
                arange(128) % 8; exact), then seeded fp32 at the CPE
                tap-gradient reduction's size (3136 * 64 rows into 64
                channels) twice, and into 4096 random bins (each run
                straight to global atomics); keep (the fixed-order fp32
                partials of k_wgrad_tc / k_cpe_grads_reduce) when the two
                tap runs differ in any bit.
  pltpu_roll    ``roll_rows_probe``: (3136, 64) fp32 shifted by 56 flat
                rows (one image row of stage 0) with 16-byte loads,
                wrapping as jnp.roll. A roll by whole rows of a contiguous
                array is a flat roll of 16-byte vectors, so the kernel
                copies flat vectors with a wrap (``roll_plan``, which
                normalises the shift as torch.roll does); keep when exact.
  reshape_c320  ``fold_probe``: (4, 784, 320) bf16 folded into (3136, 320).
                For a contiguous input the folded row index r * N + n is
                the flat one, so the kernel copies flat 16-byte vectors
                (``fold_plan``; a 640-byte row is 40 aligned vectors, what
                the Mosaic probe asked); keep (in the port the fold is a
                view) when exact.
  cluster       ``cluster_probe``: clusters of 1, 2, 4, 8 and 16 CTAs (16
                with the non-portable opt-in), each CTA reading its peers'
                ranks from global and distributed shared memory after the
                cluster barrier; keep the portable cap of 8 when 16 does
                not launch (no model kernel uses clusters since s_stage.cu
                became one persistent launch of the S block's tiles).

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs its ``*_plain`` version. ``LAUNCHES`` counts the kernels'
launches. ``PROBES[name](device)`` runs one probe and returns its result
row; on the CPU it runs the plain versions only, and the row says so. On
the card a row gives each kernel's time by CUDA events around its wrapper
("ms", host-paced where the kernel is short) and by the profiler's device
time of the kernel alone ("kernel_ms"), with its library call's likewise,
beside the card's launch floor ("launch_floor_ms": the device time of a
one-element fill). At the probes' shapes the erf's, the roll's and the
fold's bytes take less than that floor, so their rows also time them at a
size where the bytes set the pace ("large").
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lemevit_tpu_torch import probes
from lemevit_tpu_torch.utils.profiling import (HBM_BYTES_PER_S, cuda_ms,
                                               kernel_ms)

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
ERF_THREADS = 128        # constructs.cu::kErfThreads
NOISE = 0.02             # device times closer than this decide no verdict
SCATTER_X = (128, 128)   # JAX's scatter input, rows into arange % 8
SCATTER_BINS = 8
TAP_ROWS, TAP_CH = 3136 * 64, 64   # k_cpe_tap_grads' rows at stage 0
RANDOM_BINS = 4096       # the global-atomic branch's check: random bins
SCATTER_THREADS = 256
SCATTER_CTAS = 2 * 132   # two CTAs an SM of the H100
SCATTER_SMEM = 96 * 1024  # constructs.cu::kScatterSmem
ROLL_X, ROLL_SHIFT = (3136, 64), 56
ROLL_X_LARGE = (3136 * 64, 64)  # 51.4 MB each way, past the 50 MB L2
ROLL_THREADS = 128       # constructs.cu::kRollThreads
ROLL_VPT = 4             # constructs.cu::kRollVpt: vectors a thread
FOLD_X = (4, 784, 320)
FOLD_X_LARGE = (64, 784, 320)   # 32.1 MB each way: the bytes set the pace
FOLD_THREADS = 128       # constructs.cu::kFoldThreads
FOLD_VPT = 4             # constructs.cu::kFoldVpt: vectors a thread
MAX_INT = 2 ** 31 - 1    # the kernels' counts are int32
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


def scatter_plan(rows: int, cols: int, out_rows: int) -> dict:
    """How ``k_scatter_add_probe`` walks (rows, cols) into out_rows bins:
    ``quads`` = cols / 4 threads per row (float4 loads), ``lanes`` = 256 //
    quads rows walked at once per CTA, each lane ``per_lane`` consecutive
    rows, ``grid`` CTAs (about SCATTER_CTAS), and ``shared``: whether the
    CTA's (out_rows, cols) fp32 partial fits SCATTER_SMEM. Raises where the
    kernel takes no such shape (cols not a multiple of 4, or above 1024)."""
    if cols % 4 or not 4 <= cols <= 4 * SCATTER_THREADS or rows < 1:
        raise ValueError(f"scatter_add_probe: rows >= 1 and C a multiple of "
                         f"4 up to {4 * SCATTER_THREADS} expected, got "
                         f"({rows}, {cols})")
    quads = cols // 4
    lanes = SCATTER_THREADS // quads
    per_lane = -(-rows // (lanes * SCATTER_CTAS))
    return {"quads": quads, "lanes": lanes, "per_lane": per_lane,
            "grid": -(-rows // (lanes * per_lane)),
            "shared": out_rows * cols * 4 <= SCATTER_SMEM}


def scatter_add_probe_tiles_plain(x, idx, out_rows: int) -> torch.Tensor:
    """``k_scatter_add_probe``'s order of work in PyTorch, fp32: each lane
    of ``scatter_plan`` sums its runs of equal idx in row order (a run
    starts at its first row) and flushes each run, at its end, into its
    CTA's partial (``shared``) or into out. The kernel's atomics meet in an
    order the card chooses; this model fixes one: the flushes of one row
    step by lane, then the CTAs' partials in CTA order."""
    rows, cols = x.shape
    p = scatter_plan(rows, cols, out_rows)
    lane = torch.arange(p["grid"] * p["lanes"])
    first = lane * p["per_lane"]
    end = (first + p["per_lane"]).clamp(max=rows)
    # the partial each lane flushes into: its CTA's, or out itself
    where = lane // p["lanes"] if p["shared"] else torch.zeros_like(lane)
    part = torch.zeros(int(where.max()) + 1, out_rows, cols)
    x, idx = x.float().cpu(), idx.long().cpu()
    acc = torch.zeros(len(lane), cols)
    bin_ = torch.full((len(lane),), -1)

    def flush(sel):
        sel = sel & (bin_ >= 0)
        part.index_put_((where[sel], bin_[sel]), acc[sel], accumulate=True)
    for j in range(p["per_lane"]):
        r = first + j
        live = r < end
        rr = r.clamp(max=rows - 1)
        new = live & (idx[rr] != bin_)
        flush(new)
        acc = torch.where(new[:, None], x[rr],
                          torch.where(live[:, None], acc + x[rr], acc))
        bin_ = torch.where(new, idx[rr], bin_)
    flush(torch.ones_like(bin_, dtype=torch.bool))
    out = torch.zeros(out_rows, cols)
    for cta_part in part:  # in CTA order
        out = out + cta_part
    return out


def roll_rows_probe_plain(x, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, 0)


def roll_plan(rows: int, cols: int, shift: int) -> dict:
    """How ``k_roll_rows_probe`` rolls a contiguous (rows, cols) fp32
    array by ``shift`` rows: as a flat roll of ``n`` = rows * cols / 4
    16-byte vectors by ``s`` = (shift % rows) * cols / 4 vectors (the shift
    normalised as torch.roll does, here in Python, so any int, negative or
    past int32, reaches the kernel as 0 <= s < n), output vector i reading
    vector i - s, or i - s + n below s. ``grid`` CTAs of ``threads``, each
    a tile of threads * ``per_thread`` vectors, thread t of CTA b holding
    vectors b * tile + t + j * threads (j < per_thread); ``full`` tiles run
    unmasked and the last ``tail`` vectors (a partial tile; 0 when every
    tile is full) one at a time. Raises where the kernel takes no such
    shape (rows below 1, cols not a positive multiple of 4, or n past
    int32)."""
    if rows < 1 or cols < 4 or cols % 4:
        raise ValueError(f"roll_rows_probe: rows >= 1 and C a positive "
                         f"multiple of 4 expected, got ({rows}, {cols})")
    n = rows * (cols // 4)
    if n > MAX_INT:
        raise ValueError(f"roll_rows_probe: at most {MAX_INT} 16-byte "
                         f"vectors, got {n}")
    tile = ROLL_THREADS * ROLL_VPT
    return {"threads": ROLL_THREADS, "per_thread": ROLL_VPT,
            "grid": -(-n // tile), "full": n // tile, "tail": n % tile,
            "n": n, "s": shift % rows * (cols // 4)}


def _roll_source(i, n: int, s: int):
    """The vector k_roll_rows_probe reads for output vector i."""
    return torch.where(i < s, i + (n - s), i - s)


def roll_rows_probe_tiles_plain(x, shift: int) -> torch.Tensor:
    """``k_roll_rows_probe``'s order of work in PyTorch: the full tiles of
    ``roll_plan``, each thread's ``per_thread`` vectors loaded before they
    are stored, then the tail one vector at a time; every vector is a
    16-byte copy, so the result is exact."""
    rows, cols = x.shape
    p = roll_plan(rows, cols, shift)
    n, s, t = p["n"], p["s"], p["threads"]
    src = x.reshape(n, 4)
    out = torch.full_like(src, float("nan"))
    tile = t * p["per_thread"]
    # (CTA, vector j of the thread, thread): b * tile + j * threads + t
    i = (torch.arange(p["full"])[:, None, None] * tile
         + torch.arange(p["per_thread"])[None, :, None] * t
         + torch.arange(t)[None, None, :]).reshape(-1).to(x.device)
    out[i] = src[_roll_source(i, n, s)]
    # the last CTA's threads walk the tail, each by ``threads`` vectors
    i = torch.arange(p["full"] * tile, n, device=x.device)
    out[i] = src[_roll_source(i, n, s)]
    return out.reshape(rows, cols)


def fold_probe_plain(x) -> torch.Tensor:
    r, n, c = x.shape
    return x.reshape(r * n, c).clone()


def fold_plan(n_vectors: int) -> dict:
    """How ``k_fold_probe`` copies n_vectors 16-byte vectors: ``grid`` CTAs
    of ``threads``, each a tile of threads * ``per_thread`` vectors, thread
    t of CTA b holding vectors b * tile + t + j * threads (j < per_thread);
    ``full`` tiles run unmasked and the last ``tail`` vectors (a partial
    tile; 0 when every tile is full) one at a time. About two CTAs an SM
    of the 132 at the probe's shape (245 CTAs). Raises where the kernel
    takes no such count (below 1, or past int32)."""
    if not 1 <= n_vectors <= MAX_INT:
        raise ValueError(f"fold_probe: 1 to {MAX_INT} 16-byte vectors "
                         f"expected, got {n_vectors}")
    tile = FOLD_THREADS * FOLD_VPT
    return {"threads": FOLD_THREADS, "per_thread": FOLD_VPT,
            "grid": -(-n_vectors // tile), "full": n_vectors // tile,
            "tail": n_vectors % tile}


def erf_plan(n: int) -> dict:
    """How ``k_erf_probe`` lays out n fp32 elements: thread i < ``vectors``
    (= n // 4) takes the float4 of elements 4i .. 4i + 3, thread
    ``vectors`` the ``tail`` = n % 4 elements left, in ``grid`` CTAs of
    ``threads`` (128 CTAs at the probe's shape, about one wave). Raises
    where the kernel takes no such count (below 1, or past int32)."""
    if not 1 <= n <= MAX_INT:
        raise ValueError(f"erf_probe: 1 to {MAX_INT} elements expected, "
                         f"got {n}")
    vectors, tail = divmod(n, 4)
    return {"threads": ERF_THREADS, "vectors": vectors, "tail": tail,
            "grid": -(-(vectors + (tail > 0)) // ERF_THREADS)}


def cluster_probe_plain(csize: int, clusters: int) -> torch.Tensor:
    """What k_cluster_probe writes: per CTA its rank, then every peer's
    rank twice (read from global and from shared memory)."""
    ranks = np.arange(csize, dtype=np.int32)
    row = lambda r: np.concatenate([[r], ranks, ranks])
    return torch.from_numpy(np.tile(np.stack([row(r) for r in ranks]),
                                    (clusters, 1)).reshape(-1))


# ---------------------------------------------------------------- CUDA


def erf_probe(x, poly: bool = False, k: int = 1) -> torch.Tensor:
    """``erf_probe_plain`` on fp32 x: ``k_erf_probe<poly>`` as
    ``erf_plan`` lays it out."""
    if not x.is_cuda:
        return erf_probe_plain(x, poly, k)
    probes.check_cuda("erf_probe", x, dtype=torch.float32)
    if k < 1:
        raise ValueError(f"erf_probe: k={k}; at least one evaluation")
    plan = erf_plan(x.numel())
    out = torch.empty_like(x)
    probes.launch("erf_probe", x, int(poly), k, x, out, x.numel(),
                  plan["grid"], counts=LAUNCHES)
    return out


def scatter_add_probe(x, idx, out_rows: int) -> torch.Tensor:
    """out[idx[r]] += x[r], per-CTA partials meeting by global atomicAdd:
    ``k_scatter_add_probe`` as ``scatter_plan`` lays it out."""
    if not x.is_cuda:
        return scatter_add_probe_plain(x, idx, out_rows)
    probes.check_cuda("scatter_add_probe", x, dtype=torch.float32)
    probes.check_cuda("scatter_add_probe", idx, dtype=torch.int32)
    if x.dim() != 2 or idx.shape != (x.shape[0],) or idx.device != x.device:
        raise ValueError("scatter_add_probe: x (rows, C) and idx (rows,) on "
                         "one device expected")
    plan = scatter_plan(x.shape[0], x.shape[1], out_rows)
    if int(idx.min()) < 0 or int(idx.max()) >= out_rows:
        raise ValueError("scatter_add_probe: an index is out of range")
    out = torch.zeros(out_rows, x.shape[1], dtype=x.dtype, device=x.device)
    probes.launch("scatter_add_probe", x, x, idx, out, x.shape[0],
                  x.shape[1], out_rows, plan["per_lane"], plan["grid"],
                  int(plan["shared"]), counts=LAUNCHES)
    return out


def roll_rows_probe(x, shift: int) -> torch.Tensor:
    """torch.roll(x, shift, 0) by 16-byte loads: ``k_roll_rows_probe``, a
    flat copy with a wrap as ``roll_plan`` lays it out (any int shift)."""
    if not x.is_cuda:
        return roll_rows_probe_plain(x, shift)
    probes.check_cuda("roll_rows_probe", x, dtype=torch.float32)
    if x.dim() != 2:
        raise ValueError("roll_rows_probe: (rows, C) expected, got "
                         f"{tuple(x.shape)}")
    plan = roll_plan(x.shape[0], x.shape[1], shift)
    out = torch.empty_like(x)
    probes.launch("roll_rows_probe", x, x, out, plan["n"], plan["s"],
                  plan["grid"], counts=LAUNCHES)
    return out


def fold_probe(x) -> torch.Tensor:
    """(R, N, C) -> (R * N, C): ``k_fold_probe``, a flat copy of 16-byte
    vectors as ``fold_plan`` lays it out."""
    if not x.is_cuda:
        return fold_probe_plain(x)
    probes.check_cuda("fold_probe", x, dtype=torch.bfloat16)
    if x.dim() != 3 or x.shape[2] % 8:
        raise ValueError("fold_probe: (R, N, C) with C a multiple of 8 "
                         f"expected, got {tuple(x.shape)}")
    r, n, c = x.shape
    nvec = x.numel() // 8
    plan = fold_plan(nvec)
    out = torch.empty(r * n, c, dtype=x.dtype, device=x.device)
    probes.launch("fold_probe", x, x, out, nvec, plan["grid"],
                  counts=LAUNCHES)
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


def roll_input(device, shape=ROLL_X) -> torch.Tensor:
    """(3136, 64) fp32 (or ``shape``) whose every element differs (its
    flat index, exact in fp32 below 2**24)."""
    return torch.arange(shape[0] * shape[1], dtype=torch.float32).reshape(
        shape).to(device)


def fold_input(device, shape=FOLD_X) -> torch.Tensor:
    """(4, 784, 320) bf16 (or ``shape``), seeded."""
    g = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=g).to(torch.bfloat16).to(device)


def launch_floor_ms(device) -> float | None:
    """The card's launch floor: the profiler's device ms of a one-element
    ``zero_()``, the least a kernel launch shows on the device."""
    z = torch.zeros(1, device=device)
    return kernel_ms(z.zero_, 20, 3)


def _times(device, kernel, name, plain, library=None, nbytes=0) -> dict:
    """On the card: the kernel's, the plain version's and the library
    call's ms by CUDA events around each call ("ms", "plain_ms",
    "library_ms"), the profiler's device ms of the kernel alone (the
    kernels whose name holds ``name``: "kernel_ms") and of the library
    call ("library_kernel_ms"), the bytes bound and the launch floor
    (``launch_floor_ms``); "not measured" on the CPU."""
    keys = ("ms", "kernel_ms", "plain_ms", "library_ms", "library_kernel_ms",
            "bound_ms", "launch_floor_ms")
    if torch.device(device).type != "cuda":
        return dict.fromkeys(keys, "not measured")
    lib = (None, None) if library is None else (
        cuda_ms(library), kernel_ms(library, 20, 3))
    return dict(zip(keys, (cuda_ms(kernel), kernel_ms(kernel, 20, 3, name),
                           cuda_ms(plain), *lib,
                           nbytes / HBM_BYTES_PER_S * 1e3,
                           launch_floor_ms(device))))


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
    # the timed form too: ERF_SLOPE_K evaluations summed per element, per
    # evaluation against the plain sums and (erff) against the fp64 sum of
    # erf at the same fp32 arguments
    err_k = max((erf_probe(x, pf, ERF_SLOPE_K) - erf_probe_plain(
        x, pf, ERF_SLOPE_K)).abs().max().item() / ERF_SLOPE_K
        for pf in (False, True))
    exact_k = sum(torch.erf((x * (1.0 + p * (1.0 / 1024.0))).double())
                  for p in range(ERF_SLOPE_K))
    err_k_fp64 = (erf_probe(x, False, ERF_SLOPE_K).double() - exact_k
                  ).abs().max().item() / ERF_SLOPE_K
    row = {"route": route, "err": err, "err_poly": err_poly,
           "err_k_fp64": err_k_fp64, "err_vs_plain": max(
               (got - erf_probe_plain(x)).abs().max().item(),
               (poly - erf_probe_plain(x, poly=True)).abs().max().item(),
               err_k)}
    row.update(_times(device, lambda: erf_probe(x), "k_erf_probe",
                      lambda: erf_probe_plain(x), lambda: torch.erf(x),
                      2 * x.numel() * 4))
    faster, err_large = True, 0.0
    if route == "cuda":
        # the tile repeated ERF_TILES times (enough threads to fill the
        # card): K = 1 where the bytes set the pace, then us per evaluation
        # over one (256, 256) tile, the slope over k, as vpu_probe times
        # its ops
        xs = x.repeat(ERF_TILES, 1)
        err_large = (erf_probe(xs).double() - torch.erf(xs.double())
                     ).abs().max().item()
        row["large"] = {"shape": list(xs.shape), "err": err_large,
                        **_times(device, lambda: erf_probe(xs),
                                 "k_erf_probe", lambda: erf_probe_plain(xs),
                                 lambda: torch.erf(xs), 2 * xs.numel() * 4)}
        for name, poly_form in (("erff", False), ("poly", True)):
            t1, tk = (cuda_ms(lambda: erf_probe(xs, poly_form, k))
                      for k in (1, ERF_SLOPE_K))
            row[f"{name}_us_per_tile"] = ((tk - t1) / (ERF_SLOPE_K - 1)
                                          / ERF_TILES * 1e3)
        faster = (row["erff_us_per_tile"]
                  <= (1 + NOISE) * row["poly_us_per_tile"])
    row["ok"] = max(err, err_k_fp64, err_large,
                    row["err_vs_plain"]) <= ERF_TOL
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


def sum_err(got, x, idx, out_rows) -> float:
    """The largest |got - the fp64 sum| over 1e-6 of the bin's sum of |x|
    (fp32 sums of any order stay within it); 0 where a bin is empty."""
    i = idx.long()
    ref = torch.zeros(out_rows, x.shape[1], dtype=torch.float64,
                      device=x.device).index_add_(0, i, x.double())
    tol = 1e-6 * torch.zeros_like(ref).index_add_(0, i, x.abs().double())
    err = (got.double() - ref).abs()
    return (err / tol.clamp_min(1e-300)).max().item()


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
    err = sum_err(a, xs, zeros, 1)
    same = bool(torch.equal(a, b))
    bins = torch.randint(0, RANDOM_BINS, (TAP_ROWS,), generator=g,
                         dtype=torch.int32).to(device)
    err_bins = sum_err(scatter_add_probe(xs, bins, RANDOM_BINS), xs, bins,
                        RANDOM_BINS)
    route = _label(device)
    row = {"route": route, "exact_jax_input": exact,
           "tap_sum_err_over_tol": err, "two_runs_bitwise_equal": same,
           "random_bins_err_over_tol": err_bins,
           "shared_partial": {
               "jax": scatter_plan(*SCATTER_X, SCATTER_X[0])["shared"],
               "tap": scatter_plan(TAP_ROWS, TAP_CH, 1)["shared"],
               "random_bins": scatter_plan(TAP_ROWS, TAP_CH,
                                           RANDOM_BINS)["shared"]},
           "err": (got - scatter_add_probe_plain(x, idx, SCATTER_X[0])
                   ).abs().max().item()}
    # the library call adds into a buffer made once, so that both device
    # times are the scatter's kernel alone
    into = torch.zeros(1, TAP_CH, device=xs.device)
    row.update(_times(
        device, lambda: scatter_add_probe(xs, zeros, 1),
        "k_scatter_add_probe", lambda: scatter_add_probe_plain(xs, zeros, 1),
        lambda: into.index_add_(0, zeros, xs),
        (xs.numel() + TAP_ROWS + TAP_CH) * 4))
    row["ok"] = exact and err <= 1.0 and err_bins <= 1.0
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
                      "k_roll_rows_probe",
                      lambda: roll_rows_probe_plain(x, ROLL_SHIFT),
                      lambda: torch.roll(x, ROLL_SHIFT, 0),
                      2 * x.numel() * 4))
    if row["route"] == "cuda":  # where the bytes set the pace
        xl = roll_input(device, ROLL_X_LARGE)
        exact_large = bool(torch.equal(roll_rows_probe(xl, ROLL_SHIFT),
                                       torch.roll(xl, ROLL_SHIFT, 0)))
        row["large"] = {"shape": list(ROLL_X_LARGE), "exact": exact_large,
                        **_times(device, lambda: roll_rows_probe(
                            xl, ROLL_SHIFT), "k_roll_rows_probe",
                            lambda: roll_rows_probe_plain(xl, ROLL_SHIFT),
                            lambda: torch.roll(xl, ROLL_SHIFT, 0),
                            2 * xl.numel() * 4)}
        exact = exact and exact_large
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
    row.update(_times(device, lambda: fold_probe(x), "k_fold_probe",
                      lambda: fold_probe_plain(x),
                      lambda: x.reshape(-1, FOLD_X[2]).clone(),
                      2 * x.numel() * 2))
    if row["route"] == "cuda":  # where the bytes set the pace
        xl = fold_input(device, FOLD_X_LARGE)
        exact_large = bool(torch.equal(fold_probe(xl),
                                       xl.reshape(-1, FOLD_X[2])))
        row["large"] = {"shape": list(FOLD_X_LARGE), "exact": exact_large,
                        **_times(device, lambda: fold_probe(xl),
                                 "k_fold_probe", lambda: fold_probe_plain(xl),
                                 lambda: xl.reshape(-1, FOLD_X[2]).clone(),
                                 2 * xl.numel() * 2)}
        exact = exact and exact_large
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
    row.update(ms=sizes[8]["ms"], library_ms=None, library_kernel_ms=None,
               kernel_ms=kernel_ms(lambda: cluster_probe(
                   8, CLUSTERS, device), 20, 3, "k_cluster_probe"),
               plain_ms=cuda_ms(lambda: cluster_probe_plain(
                   8, CLUSTERS).to(device)),
               bound_ms=4 * CLUSTERS * 8 * 17 / HBM_BYTES_PER_S * 1e3)
    row["verdict"] = _verdict(
        route, not wide,
        "clusters of 16 do not launch; the portable cap of 8 holds",
        f"a cluster of 16 launches ({sizes[16]['max_active_clusters']} "
        "active at once): the portable cap of 8 may be re-measured")
    return row


PROBES = {"erf_prim": probe_erf_prim, "scatter": probe_scatter,
          "pltpu_roll": probe_pltpu_roll,
          "reshape_c320": probe_reshape_c320, "cluster": probe_cluster}
