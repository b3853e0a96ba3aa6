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
  - cli.probe_ab's slopes from a timed row.
The JAX scripts set a compile-cache directory at import; the fixture
restores the test run's settings after importing them."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas

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
