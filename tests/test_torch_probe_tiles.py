"""PyTorch port, the probe kernels' layouts and order of work on the CPU
(the kernels themselves run on the card only, where tests/test_torch_gpu.py
and chip_smoke.py hold them against these):
  - ew.layout(C), the row ops' (lanes per row G, 16-byte vectors per lane
    V) in k_ew_probe_rows: every column in exactly one lane slot, padding
    only in a lane's last slot, the least padding among the candidates
    (G in ew.GROUPS, V <= ew.MAX_V: 64 fp32 registers a lane), and V odd
    below G = 32 (the kernel's instances);
  - ew_probe_plain against scripts/vpu_probe.py::build (its Pallas kernel
    in interpret mode) on (8, 384) and (8, 784) tiles, where the kernel's
    layout is exact and padded, for the row ops and gelu_fast at k = 1:
    within 1 bf16 step;
  - constructs.scatter_plan as a pure function: the rows every CTA walks
    cover the input once, about SCATTER_CTAS CTAs, the shared partial
    where it fits, the refusals;
  - constructs.scatter_add_probe_tiles_plain (the kernel's runs, lanes and
    per-CTA partials) against scripts/mosaic_probes.py::probe_scatter's
    Pallas kernel in interpret mode (exact: JAX's input sums whole
    numbers) and against the fp64 sum within the probe's tolerance (1e-6
    of each bin's sum of |x|) in both of the kernel's branches;
  - cli.probe_ab's slopes from a timed row, the erf's slopes per tile,
    its report of the construct probes' bounds, the erf's slopes and the
    launch floor, and its large fold input equal to constructs.fold_input's;
  - constructs.fold_plan and erf_plan as pure functions: by the kernels'
    rule (k_fold_probe: thread t of CTA b holds vectors b * tile + t + j *
    threads; k_erf_probe: thread i the float4 of elements 4i .. 4i + 3,
    thread n // 4 the n % 4 tail) every vector or element is covered once
    and nothing past the end, at the probes' shapes, the large shapes and
    ragged sizes, no CTA empty, and the refusals;
  - the erf's and the fold's wrappers on the CPU (their plain versions)
    against scripts/mosaic_probes.py's probe_erf_prim and
    probe_reshape_c320 in interpret mode, the erf's K-sum against JAX's
    kernel on each of its K arguments and against the fp64 sum;
  - constructs.roll_plan as a pure function: by k_roll_rows_probe's rule
    (thread t of CTA b holds vectors b * tile + t + j * threads, reading
    vector i - s, or i - s + n below s) every output vector is written
    once, nothing past n, and each from np.roll's source vector, at the
    probe's shape, the large shape and ragged sizes (n = 1, a tile and
    one either side, cols = 4 and 12); the shift normalised as shift % rows
    (0, 1, rows - 1, rows, -57, 2**32 + 57, -2**31); the refusals;
  - constructs.roll_rows_probe_tiles_plain (roll_plan's order of work)
    exactly torch.roll at those shifts, and JAX's probe_pltpu_roll kernel
    in interpret mode on the probe's input, as the roll's CPU wrapper;
  - cli.probe_ab's large roll input equal to constructs.roll_input's,
    chip_smoke.LARGE_PROBES naming the roll, and chip_smoke.pil_status;
  - the build's ptxas report (attn/_build.py::ptxas_log, with a stand-in
    nvcc) and chip_smoke.py's reading of it (ptxas_report,
    check_probe_ptxas: a spill, a stack frame or a missing instance
    fails).
The JAX scripts set a compile-cache directory at import; the fixture
restores the test run's settings after importing them."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas

import chip_smoke
from lemevit_tpu_torch import probes
from lemevit_tpu_torch.attn import _build
from lemevit_tpu_torch.cli import probe_ab
from lemevit_tpu_torch.probes import constructs, ew

_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_scripts():
    """scripts.vpu_probe and scripts.mosaic_probes, with the test run's
    compile-cache settings restored after their import."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        import scripts.mosaic_probes as jm
        import scripts.vpu_probe as jv
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return jv, jm


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode; returns the (args, output) of every
    kernel run."""
    orig = pallas.pallas_call
    runs = []

    def wrapper(*a, **kw):
        f = orig(*a, **{**kw, "interpret": True})

        def run(*args):
            out = f(*args)
            runs.append((args, out))
            return out
        return run
    monkeypatch.setattr(pallas, "pallas_call", wrapper)
    return runs


def _torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


# ---------------------------------------------------------------- ew probe

# (C, its layout): one vector in a group of 8 lanes, exact fits, the
# padded 784 (98 vectors in 112 slots), the widest
LAYOUTS = [(8, (8, 1)), (128, (16, 1)), (384, (16, 3)), (784, (16, 7)),
           (1536, (32, 6)), (2048, (32, 8))]


@pytest.mark.parametrize("cols,want", LAYOUTS)
def test_ew_layout(cols, want):
    g, v = ew.layout(cols)
    assert (g, v) == want
    nvec = cols // 8
    # column c is element c % 8 of vector c // 8, in lane j % G, slot j // G
    places = {((c // 8) % g, (c // 8) // g, c % 8) for c in range(cols)}
    assert len(places) == cols
    assert all(slot < v for _, slot, _ in places)
    # every slot but a lane's last holds an element in every lane
    assert all(s * g + lane < nvec for lane in range(g)
               for s in range(v - 1))
    assert v <= ew.MAX_V and v * 8 <= 64 and g in ew.GROUPS
    least = min(gg * -(-nvec // gg) for gg in ew.GROUPS
                if -(-nvec // gg) <= ew.MAX_V)
    assert g * v == least
    assert g == 32 or v % 2 == 1
    assert g * v - nvec == {8: 7, 784: 14}.get(cols, 0)


def test_ew_layout_every_width_has_an_instance():
    """Every C the kernel takes maps to one of k_ew_probe_rows' instances:
    G in ew.GROUPS, V odd below G = 32, 1 <= V <= ew.MAX_V."""
    got = {ew.layout(c) for c in range(8, ew.MAX_COLS + 1, 8)}
    assert got == ({(32, v) for v in range(1, ew.MAX_V + 1)}
                   | {(g, v) for g in (8, 16) for v in (1, 3, 5, 7)})


def test_ew_layout_refuses():
    for cols in (0, 12, ew.MAX_COLS + 8):
        with pytest.raises(ValueError, match="multiple of 8"):
            ew.layout(cols)


@pytest.mark.parametrize("cols", [384, 784])
@pytest.mark.parametrize("op", ["ln", "rowmax", "rowsum", "gelu_fast"])
def test_ew_plain_matches_vpu_probe_tiles(jax_scripts, interpret, op, cols):
    jv = jax_scripts[0]
    x = (np.random.RandomState(cols).randn(16, cols) * 0.5).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = _torch(jv.build(op, 1, 8, cols, 2)(xb)).to(torch.bfloat16)
    got = ew.ew_probe(_torch(xb).to(torch.bfloat16), op, 1)
    assert got.dtype == torch.bfloat16 and got.shape == (16, cols)
    assert ew.mismatches(got, want, 1)["max_ulp"] <= 1


# ---------------------------------------------------------------- scatter


@pytest.mark.parametrize("rows,cols,out_rows,shared", [
    (constructs.TAP_ROWS, constructs.TAP_CH, 1, True),
    (*constructs.SCATTER_X, constructs.SCATTER_X[0], True),
    (constructs.TAP_ROWS, constructs.TAP_CH, constructs.RANDOM_BINS, False),
    (777, 12, 3, True), (5000, 320, 16, True), (3, 1024, 24, True),
    (100000, 4, 1, True)])
def test_scatter_plan(rows, cols, out_rows, shared):
    p = constructs.scatter_plan(rows, cols, out_rows)
    assert p["quads"] == cols // 4
    assert p["lanes"] == constructs.SCATTER_THREADS // p["quads"] >= 1
    span = p["lanes"] * p["per_lane"]
    # the CTAs' row ranges cover every row once, none of them empty
    assert (p["grid"] - 1) * span < rows <= p["grid"] * span
    assert p["grid"] <= constructs.SCATTER_CTAS
    assert p["per_lane"] == -(-rows // (p["lanes"] * constructs.SCATTER_CTAS))
    assert p["shared"] is shared
    assert shared == (out_rows * cols * 4 <= constructs.SCATTER_SMEM)


def test_scatter_plan_refuses():
    for rows, cols in ((10, 6), (10, 1028), (0, 64)):
        with pytest.raises(ValueError, match="multiple of 4"):
            constructs.scatter_plan(rows, cols, 1)
    assert constructs.scatter_plan(*constructs.SCATTER_X, 200)[
        "shared"] is False


def test_scatter_tiles_match_mosaic_probe(jax_scripts, interpret,
                                          monkeypatch, capsys):
    jm = jax_scripts[1]
    monkeypatch.setattr(jm, "_setup_jax", lambda: jax)
    jm.probe_scatter()
    assert "COMPILED_OK" in capsys.readouterr().out
    args, out = interpret[-1]
    x, idx = constructs.scatter_input("cpu")
    np.testing.assert_array_equal(np.asarray(args[1])[:, 0], idx)
    got = constructs.scatter_add_probe_tiles_plain(x, idx,
                                                   constructs.SCATTER_X[0])
    assert torch.equal(got, _torch(out))


@pytest.mark.parametrize("rows,cols,bins,sort", [
    (20000, 64, 1, False), (20000, 64, constructs.RANDOM_BINS, False),
    (5000, 320, 16, True), (777, 12, 3, False)])
def test_scatter_tiles_within_tolerance_of_fp64(rows, cols, bins, sort):
    g = torch.Generator().manual_seed(rows + bins)
    x = torch.randn(rows, cols, generator=g)
    idx = torch.randint(0, bins, (rows,), generator=g, dtype=torch.int32)
    if sort:
        idx = idx.sort().values
    got = constructs.scatter_add_probe_tiles_plain(x, idx, bins)
    assert got.dtype == torch.float32 and got.shape == (bins, cols)
    assert constructs.sum_err(got, x, idx, bins) <= 1.0
    assert constructs.sum_err(constructs.scatter_add_probe_plain(
        x, idx, bins), x, idx, bins) <= 1.0


# ---------------------------------------------------------------- probe_ab


def test_probe_ab_slopes():
    row = {"r": 2, "c": 8, "k0": {"ms": 1.0, "device_ms": 0.5}, "ops": {
        "exp": {"k": 8, "kj": {"ms": 1.8, "device_ms": 1.3}},
        "ln": {"k": 4, "kj": {"ms": 2.0, "device_ms": None}}}}
    s = probe_ab.slopes(row)
    assert s["exp"]["us_per_pass"] == pytest.approx(0.8 / 8 / 64 * 1e3)
    assert s["exp"]["us_per_pass_device"] == pytest.approx(
        0.8 / 8 / 64 * 1e3)
    assert s["exp"]["ps_per_element"] == pytest.approx(
        0.8 / 8 * 1e9 / (2 * 64 * 8))
    assert s["ln"]["us_per_pass_device"] is None
    assert s["ln"]["ps_per_element"] is None


ERF_SLOPE = {"k": 33, "tiles": 64,
             "erff": {"k1": {"ms": 0.010, "device_ms": 0.008},
                      "k33": {"ms": 0.138, "device_ms": 0.136}},
             "poly": {"k1": {"ms": 0.010, "device_ms": None},
                      "k33": {"ms": 0.106, "device_ms": 0.104}}}


def test_probe_ab_erf_slopes():
    s = probe_ab.erf_slopes(ERF_SLOPE)
    assert s["erff"]["us_per_tile"] == pytest.approx(0.128 / 32 / 64 * 1e3)
    assert s["erff"]["us_per_tile_device"] == pytest.approx(
        0.128 / 32 / 64 * 1e3)
    assert s["poly"]["us_per_tile"] == pytest.approx(0.096 / 32 / 64 * 1e3)
    assert s["poly"]["us_per_tile_device"] is None


def test_probe_ab_report_shows_bounds_slopes_and_floor():
    entry = {"kernel": {"device_ms": 0.0015}, "library": {
        "device_ms": 0.0014}, "bytes": 2 * 1003520 * 2}
    run = {"root": "a", "card": "card", "ew": [], "launch_floor_ms": 0.001,
           "constructs": {"fold": entry}, "erf_slope": ERF_SLOPE}
    lines = probe_ab.report([run, {**run, "root": "b"}])
    assert lines[1].split() == ["fold", "kernel", "0.0015", "0.0015", "|",
                                "library", "0.0014", "0.0014", "|", "bytes",
                                "bound", "0.00120"]
    assert lines[2].startswith("erf slope erff: us per tile per evaluation, "
                               "device 0.0625 0.0625 | events 0.0625 0.0625")
    assert lines[3].startswith("erf slope poly: us per tile per evaluation, "
                               "device - - | events")
    assert lines[-1] == "launch floor (device) 0.001 0.001"


def test_probe_ab_large_fold_input_is_fold_inputs():
    """The harness makes the large fold input itself (a parent root's
    package may lack it): the shape and bits of constructs.fold_input."""
    assert probe_ab.FOLD_LARGE == constructs.FOLD_X_LARGE
    g = torch.Generator().manual_seed(0)
    mine = torch.randn(probe_ab.FOLD_LARGE, generator=g).to(torch.bfloat16)
    assert torch.equal(mine, constructs.fold_input(
        "cpu", constructs.FOLD_X_LARGE))


# ---------------------------------------------------------- fold and erf

FOLD_N = [int(np.prod(constructs.FOLD_X)) // 8,
          int(np.prod(constructs.FOLD_X_LARGE)) // 8, 1, 1023, 1024, 1025,
          4097]


@pytest.mark.parametrize("n", FOLD_N)
def test_fold_plan_covers_every_vector_once(n):
    p = constructs.fold_plan(n)
    t, v = p["threads"], p["per_thread"]
    assert (t, v) == (constructs.FOLD_THREADS, constructs.FOLD_VPT)
    tile = t * v
    # k_fold_probe: thread t of CTA b holds vectors b * tile + t + j * t
    idx = (np.arange(p["grid"])[:, None, None] * tile
           + np.arange(t)[None, :, None] + np.arange(v)[None, None, :] * t)
    live = idx[idx < n]
    assert live.size == n
    assert np.array_equal(np.sort(live), np.arange(n))
    assert (p["grid"] - 1) * tile < n <= p["grid"] * tile  # no CTA empty
    assert p["full"] == n // tile and p["tail"] == n - p["full"] * tile
    assert p["grid"] == p["full"] + (p["tail"] > 0)
    if n == FOLD_N[0]:  # about two CTAs an SM of the H100's 132
        assert p["grid"] == 245


ERF_N = [int(np.prod(constructs.ERF_TILE)),
         int(np.prod(constructs.ERF_TILE)) * constructs.ERF_TILES, 1, 2, 3,
         4, 5, 1023, 1025, 4097, 65538]


@pytest.mark.parametrize("n", ERF_N)
def test_erf_plan_covers_every_element_once(n):
    p = constructs.erf_plan(n)
    assert p["threads"] == constructs.ERF_THREADS
    assert (p["vectors"], p["tail"]) == divmod(n, 4)
    # k_erf_probe: thread i < n // 4 takes elements 4i .. 4i + 3, thread
    # n // 4 the n % 4 tail, every other thread nothing
    i = np.arange(p["grid"] * p["threads"])[:, None]
    slot = np.arange(4)[None, :]
    live = (i < p["vectors"]) | ((i == p["vectors"]) & (slot < p["tail"]))
    assert np.array_equal(np.sort((4 * i + slot)[live]), np.arange(n))
    busy = p["vectors"] + (p["tail"] > 0)
    assert (p["grid"] - 1) * p["threads"] < busy <= p["grid"] * p["threads"]
    if n == ERF_N[0]:  # about one wave of the H100's 132 SMs
        assert p["grid"] == 128


def test_fold_and_erf_plans_refuse():
    for bad in (0, -1, constructs.MAX_INT + 1):
        with pytest.raises(ValueError, match="fold_probe"):
            constructs.fold_plan(bad)
        with pytest.raises(ValueError, match="erf_probe"):
            constructs.erf_plan(bad)
    assert constructs.fold_plan(constructs.MAX_INT)["grid"] == -(
        -constructs.MAX_INT // (constructs.FOLD_THREADS
                                * constructs.FOLD_VPT))


@pytest.fixture
def interpret_calls(monkeypatch):
    """pallas_call in interpret mode; returns (kernel, args, output) of
    every kernel run, so that a test can run the kernel again."""
    orig = pallas.pallas_call
    runs = []

    def wrapper(*a, **kw):
        f = orig(*a, **{**kw, "interpret": True})

        def run(*args):
            out = f(*args)
            runs.append((f, args, out))
            return out
        return run
    monkeypatch.setattr(pallas, "pallas_call", wrapper)
    return runs


def test_erf_wrapper_on_cpu_matches_mosaic_probe(jax_scripts,
                                                 interpret_calls,
                                                 monkeypatch, capsys):
    jm = jax_scripts[1]
    monkeypatch.setattr(jm, "_setup_jax", lambda: jax)
    jm.probe_erf_prim()
    assert "COMPILED_OK" in capsys.readouterr().out
    call, args, out = interpret_calls[-1]
    # JAX's tile (its linspace rounds a few elements one step away)
    x = _torch(args[0])
    torch.testing.assert_close(x, constructs.erf_input("cpu"), rtol=0,
                               atol=1e-6)
    tol = constructs.ERF_TOL
    torch.testing.assert_close(constructs.erf_probe(x), _torch(out),
                               rtol=0, atol=tol)
    # the K-sum: JAX's kernel on each of the K arguments x (1 + p / 1024)
    k = 3
    want = sum(_torch(call(jnp.asarray((x * (1.0 + p / 1024.0)).numpy())))
               for p in range(k))
    torch.testing.assert_close(constructs.erf_probe(x, k=k), want, rtol=0,
                               atol=k * tol)
    # the slope's K against the fp64 sum at the same fp32 arguments
    k = constructs.ERF_SLOPE_K
    exact = sum(torch.erf((x * (1.0 + p * (1.0 / 1024.0))).double())
                for p in range(k))
    err = (constructs.erf_probe(x, k=k).double() - exact).abs().max()
    assert err / k <= tol


def test_fold_wrapper_on_cpu_matches_mosaic_probe(jax_scripts,
                                                  interpret_calls,
                                                  monkeypatch, capsys):
    jm = jax_scripts[1]
    monkeypatch.setattr(jm, "_setup_jax", lambda: jax)
    jm.probe_reshape_c320()
    assert "COMPILED_OK" in capsys.readouterr().out
    call, _, out = interpret_calls[-1]
    ones = torch.ones(constructs.FOLD_X, dtype=torch.bfloat16)
    assert torch.equal(constructs.fold_probe(ones).float(), _torch(out))
    x = constructs.fold_input("cpu")
    got = constructs.fold_probe(x)
    assert got.shape == (constructs.FOLD_X[0] * constructs.FOLD_X[1],
                         constructs.FOLD_X[2])
    want = call(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert torch.equal(got.float(), _torch(want))


# ---------------------------------------------------------------- roll

# n = rows * cols / 4 vectors: the probe's 50176 and the large 3211264
# (whole tiles), one vector, a tile (512) and one either side, cols = 12
ROLL_SHAPES = [constructs.ROLL_X, constructs.ROLL_X_LARGE, (1, 4), (511, 4),
               (512, 4), (513, 4), (5, 12), (1025, 8)]
ROLL_SHIFTS = ["0", "1", "rows-1", "rows", -57, 2 ** 32 + 57, -2 ** 31]


def _shift(spec, rows: int) -> int:
    return {"0": 0, "1": 1, "rows-1": rows - 1, "rows": rows}.get(spec, spec)


@pytest.mark.parametrize("rows,cols", ROLL_SHAPES)
def test_roll_plan_covers_every_vector_once(rows, cols):
    n = rows * cols // 4
    want = np.arange(n).reshape(rows, cols // 4)
    for shift in (constructs.ROLL_SHIFT, -57):
        p = constructs.roll_plan(rows, cols, shift)
        t, v = p["threads"], p["per_thread"]
        assert (t, v) == (constructs.ROLL_THREADS, constructs.ROLL_VPT)
        assert p["n"] == n and 0 <= p["s"] < n
        tile = t * v
        # k_roll_rows_probe: thread t of CTA b writes vectors b * tile + t +
        # j * t, each read from vector i - s, or i - s + n below s
        i = (np.arange(p["grid"])[:, None, None] * tile
             + np.arange(t)[None, :, None] + np.arange(v)[None, None, :] * t)
        i = i[i < n]
        assert i.size == n and np.array_equal(np.sort(i), np.arange(n))
        src = np.where(i < p["s"], i + n - p["s"], i - p["s"])
        assert src.min() >= 0 and src.max() < n
        out = np.empty(n, dtype=np.int64)
        out[i] = src
        assert np.array_equal(out, np.roll(want, shift, 0).reshape(-1))
        assert (p["grid"] - 1) * tile < n <= p["grid"] * tile  # none empty
        assert p["full"] == n // tile and p["tail"] == n - p["full"] * tile
        assert p["grid"] == p["full"] + (p["tail"] > 0)
    if (rows, cols) == constructs.ROLL_X:
        assert p["grid"] == 98


@pytest.mark.parametrize("spec", ROLL_SHIFTS)
def test_roll_plan_normalises_the_shift(spec):
    """Any int shift reaches the kernel as 0 <= s < n, (shift % rows) rows
    of vectors, as torch.roll takes it: 2**32 + 57 is 2105 rows of the
    probe's 3136, not the 57 its low 32 bits would give."""
    for rows, cols in (constructs.ROLL_X, (5, 12), (1, 4), (513, 4)):
        shift = _shift(spec, rows)
        p = constructs.roll_plan(rows, cols, shift)
        assert p["s"] == shift % rows * (cols // 4)
        assert 0 <= p["s"] < p["n"]
    if spec == 2 ** 32 + 57:
        assert constructs.roll_plan(*constructs.ROLL_X, spec)["s"] == (
            2105 * 16)


@pytest.mark.parametrize("spec", ROLL_SHIFTS)
@pytest.mark.parametrize("rows,cols", [constructs.ROLL_X, (1, 4), (513, 4),
                                       (5, 12)])
def test_roll_tiles_match_torch_roll(rows, cols, spec):
    shift = _shift(spec, rows)
    g = torch.Generator().manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=g)
    got = constructs.roll_rows_probe_tiles_plain(x, shift)
    assert torch.equal(got, torch.roll(x, shift, 0))
    # the CPU wrapper is torch.roll on the raw shift
    assert torch.equal(constructs.roll_rows_probe(x, shift), got)


def test_roll_plan_refuses():
    for rows, cols in ((0, 4), (-1, 4), (10, 6), (10, 0), (10, 2),
                       (2 ** 31, 4), (2 ** 29, 16)):
        with pytest.raises(ValueError, match="roll_rows_probe"):
            constructs.roll_plan(rows, cols, 1)
    assert constructs.roll_plan(constructs.MAX_INT, 4, -1)["s"] == (
        constructs.MAX_INT - 1)
    with pytest.raises(ValueError, match="roll_rows_probe"):
        constructs.roll_rows_probe_tiles_plain(torch.ones(4, 6), 1)


def test_roll_tiles_match_mosaic_probe(jax_scripts, interpret_calls,
                                       monkeypatch, capsys):
    jm = jax_scripts[1]
    monkeypatch.setattr(jm, "_setup_jax", lambda: jax)
    jm.probe_pltpu_roll()
    assert "COMPILED_OK" in capsys.readouterr().out
    call, _, out = interpret_calls[-1]
    ones = torch.ones(constructs.ROLL_X)
    assert torch.equal(constructs.roll_rows_probe_tiles_plain(
        ones, constructs.ROLL_SHIFT), _torch(out))
    # distinct values fix the direction: jnp.roll's, as torch.roll's
    x = constructs.roll_input("cpu")
    want = _torch(call(jnp.asarray(x.numpy())))
    assert torch.equal(constructs.roll_rows_probe_tiles_plain(
        x, constructs.ROLL_SHIFT), want)
    assert torch.equal(constructs.roll_rows_probe(x, constructs.ROLL_SHIFT),
                       want)


def test_probe_ab_large_roll_input_is_roll_inputs():
    """The harness makes the large roll input itself (a parent root's
    package may lack it): the shape and values of constructs.roll_input,
    every element distinct."""
    assert probe_ab.ROLL_LARGE == constructs.ROLL_X_LARGE
    mine = probe_ab.roll_large("cpu")
    assert torch.equal(mine, constructs.roll_input(
        "cpu", constructs.ROLL_X_LARGE))
    assert mine.dtype == torch.float32
    assert mine[-1, -1].item() == mine.numel() - 1 < 2 ** 24


def test_chip_smoke_times_the_roll_at_its_large_size():
    assert "pltpu_roll" in chip_smoke.LARGE_PROBES
    assert set(chip_smoke.LARGE_PROBES) <= set(constructs.PROBES)
    assert chip_smoke.CONSTRUCT_KERNELS["pltpu_roll"] == (
        "roll_rows_probe", "scripts/mosaic_probes.py:93")
    assert chip_smoke.PROBE_PTXAS["constructs.cu"]["k_roll_rows_probe"] == 1
    assert chip_smoke.ROLL_SHIFT_PAST_INT32 % 2 ** 32 == 57
    assert chip_smoke.pil_status().startswith(("PIL ", "PIL does not"))


# ---------------------------------------------------------------- ptxas

PTXAS_LOG = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    {frame} bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, used 0 barriers, 360 bytes cmem[0]
"""


def _ptxas(kernels) -> str:
    return "".join(PTXAS_LOG.format(name=n, frame=f, spill=sp, regs=r)
                   for n, f, sp, r in kernels)


def test_build_keeps_the_ptxas_report(tmp_path, monkeypatch):
    """_build.build compiles each source with -Xptxas -v and keeps what it
    printed beside the library: ptxas_log reads it back by file name."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!{sys.executable}
import sys
args = sys.argv[1:]
open(args[args.index("-o") + 1], "w").write("obj")
if "-c" in args and "-v" in args:
    src = args[args.index("-c") + 1].rsplit("/", 1)[-1]
    sys.stderr.write("ptxas info    : Compiling entry function "
                     "'k_" + src.split(".")[0] + "' for 'sm_90a'\\n")
""")
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// a source\n")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    so = _build.build(csrc, "probe_test")
    assert so.exists() and _build.ptxas_path(so).exists()
    log = _build.ptxas_log(csrc, "probe_test")
    assert sorted(log) == ["a.cu", "b.cu"]
    assert "'k_a'" in log["a.cu"] and "'k_b'" in log["b.cu"]
    assert json.loads(_build.ptxas_path(so).read_text()) == log


def test_chip_smoke_reads_the_probe_ptxas_report():
    clean = {"ew_probe.cu": _ptxas(
        [(f"k_ew_probe_{i}", 0, 0, 40) for i in range(229)]),
        "constructs.cu": _ptxas([("k_scatter_add_probe_t", 0, 0, 48),
                                 ("k_scatter_add_probe_f", 0, 0, 46),
                                 ("k_roll_rows_probe", 0, 0, 26),
                                 ("k_fold_probe", 0, 0, 20),
                                 ("k_erf_probe_t", 0, 0, 40),
                                 ("k_erf_probe_f", 0, 0, 38)])}
    report = {src: chip_smoke.ptxas_report(log, "/nonexistent/nvcc")
              for src, log in clean.items()}
    assert report["constructs.cu"].splitlines()[0] == (
        "k_scatter_add_probe_t: 0 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads")
    got = chip_smoke.check_probe_ptxas(report)
    assert got["constructs.cu"]["k_erf_probe"] == {
        "instances": 2, "max_registers": 40, "spill_or_stack": 0}
    assert got["ew_probe.cu"]["k_ew_probe"]["instances"] == 229
    assert got["constructs.cu"]["k_roll_rows_probe"]["max_registers"] == 26
    for name, regs in (("k_fold_probe", 20), ("k_roll_rows_probe", 26)):
        for bad in ([(name, 16, 0, regs)], [(name, 0, 8, regs)], []):
            log = clean["constructs.cu"].replace(_ptxas(
                [(name, 0, 0, regs)]), _ptxas(bad))
            with pytest.raises(AssertionError, match=name):
                chip_smoke.check_probe_ptxas({
                    **report, "constructs.cu": chip_smoke.ptxas_report(
                        log, "/nonexistent/nvcc")})
