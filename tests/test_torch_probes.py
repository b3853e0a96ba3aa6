"""PyTorch port, the toolchain probes and kernel microbenchmarks
(lemevit_tpu_torch/probes, cli/probes.py, cli/kbench.py,
cli/train_kbench.py) against the JAX scripts they port, on the CPU:
  - ew_probe_plain against scripts/vpu_probe.py::build (its Pallas kernel
    in interpret mode) for all 12 ops at k = 1 and 2 on a (16, 128) bf16
    input N(0, 1) * 0.5: within 1 bf16 step (two fp32 passes on each side
    before one bf16 rounding);
  - the construct probes' plain versions against the outputs of the four
    Pallas kernels of scripts/mosaic_probes.py in interpret mode: erf
    within 1e-6, scatter, roll and fold exact; the roll's kernel re-run on
    distinct values fixes its sign (jnp.roll's); the port's copy of the
    polynomial erf against pallas_block._erf within 1e-7;
  - cli.kbench's plain C, D and S blocks against scripts/kbench.py::
    xla_block (with and without the 3x3 CPE, JAX's as train_kbench.py's
    xla_cpe writes it) at B = 2, a 4x4 image, C = 64, 2 heads, fp32 (2e-5);
  - cli.train_kbench's loss and its gradients in x and every parameter,
    with the CPE inside the training Function (--cpe) and as F.conv2d
    before it (--cpe-ext), against jax.grad of train_kbench.py's loss on
    the same numpy inputs (loss 2e-4; gradients 5e-3, relative and, in
    absolute terms, of the largest gradient element: the loss is scaled
    by 1e-6);
  - the CLIs on the CPU (plain rows only, labelled so), their refusal
    without CUDA, the probe library's entry points against its ctypes
    signatures and its build apart from the model kernels';
  - cli.train_seg --train-cpe-in-kernel: a micro UperNet step with the
    switch equals the step without it (the Functions' plain phases).
The JAX scripts set a compile-cache directory at import; the fixture
restores the test run's settings after importing them. The kernels are
held against these plain versions on the card in tests/test_torch_gpu.py
and chip_smoke.py."""
import ctypes
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas

from lemevit_tpu.attn import pallas_block
from lemevit_tpu_torch import probes
from lemevit_tpu_torch.attn import _build
from lemevit_tpu_torch.attn import fused_train as ft
from lemevit_tpu_torch.attn.reference import dca_scales
from lemevit_tpu_torch.cli import kbench, train_kbench, train_seg
from lemevit_tpu_torch.cli import probes as probes_cli
from lemevit_tpu_torch.models import lemevit as tmod
from lemevit_tpu_torch.probes import constructs, ew

_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_scripts():
    """scripts.vpu_probe, scripts.mosaic_probes and scripts.kbench, with
    the test run's compile-cache settings restored after their import."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        import scripts.kbench as jk
        import scripts.mosaic_probes as jm
        import scripts.vpu_probe as jv
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return jv, jm, jk


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode; returns the list of (call, args,
    output) of every kernel run."""
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


def _torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


# ---------------------------------------------------------------- ew probe


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("op", list(ew.OPS))
def test_ew_plain_matches_vpu_probe(jax_scripts, interpret, op, k):
    jv = jax_scripts[0]
    x = (np.random.RandomState(0).randn(16, 128) * 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = _torch(jv.build(op, k, 8, 128, 2)(xb)).to(torch.bfloat16)
    got = ew.ew_probe(_torch(xb).to(torch.bfloat16), op, k)
    assert got.dtype == torch.bfloat16 and got.shape == (16, 128)
    assert ew.mismatches(got, want, k)["max_ulp"] <= 1


def test_ew_probe_checks():
    x = ew.probe_input(8, 16, "cpu")
    assert x.shape == (8 * ew.TILES, 16) and x.dtype == torch.bfloat16
    assert torch.equal(ew.ew_probe(x, "fma", 0), x)
    assert torch.equal(ew.ew_probe(x, "cast_rt", 8), x)
    with pytest.raises(ValueError, match="unknown op"):
        ew.ew_probe(x, "sqrt", 1)
    assert ew.jax_k("gelu_full") == ew.jax_k("ln") == 4
    assert ew.jax_k("rowsum") == 8
    one = torch.tensor([1.0, float("inf"), float("nan")],
                       dtype=torch.bfloat16)
    nxt = torch.tensor([1.0078125, float("inf"), float("nan")],
                       dtype=torch.bfloat16)
    assert ew.ulp_distance(one, nxt).tolist() == [1, 0, 0]
    assert ew.mismatches(one, nxt, 1) == {"max_ulp": 1, "bad": 0}


# ---------------------------------------------------------- construct probes


@pytest.mark.parametrize("name", ["erf_prim", "scatter", "pltpu_roll",
                                  "reshape_c320"])
def test_construct_plain_matches_mosaic_probe(jax_scripts, interpret,
                                              monkeypatch, capsys, name):
    jm = jax_scripts[1]
    monkeypatch.setattr(jm, "_setup_jax", lambda: jax)
    getattr(jm, f"probe_{name}")()
    assert "COMPILED_OK" in capsys.readouterr().out
    call, args, out = interpret[-1]
    want = _torch(out)
    if name == "erf_prim":
        got = constructs.erf_probe(constructs.erf_input("cpu"))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    elif name == "scatter":
        x, idx = constructs.scatter_input("cpu")
        np.testing.assert_array_equal(np.asarray(args[1])[:, 0], idx)
        assert torch.equal(constructs.scatter_add_probe(
            x, idx, constructs.SCATTER_X[0]), want)
    elif name == "pltpu_roll":
        ones = torch.ones(constructs.ROLL_X)
        assert torch.equal(constructs.roll_rows_probe(
            ones, constructs.ROLL_SHIFT), want)
        x = constructs.roll_input("cpu")
        assert torch.equal(constructs.roll_rows_probe(
            x, constructs.ROLL_SHIFT), _torch(call(jnp.asarray(x.numpy()))))
    else:
        ones = torch.ones(constructs.FOLD_X, dtype=torch.bfloat16)
        assert torch.equal(constructs.fold_probe(ones).float(), want)
        x = constructs.fold_input("cpu")
        got = call(jnp.asarray(x.float().numpy(), jnp.bfloat16))
        assert torch.equal(constructs.fold_probe(x).float(), _torch(got))


def test_erf_poly_matches_pallas_block():
    x = np.linspace(-5, 5, 100001, dtype=np.float32)
    want = _torch(pallas_block._erf(jnp.asarray(x)))
    got = constructs.erf_poly(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)
    assert (got.double() - torch.erf(torch.from_numpy(x).double())
            ).abs().max() < 5.2e-7


@pytest.mark.parametrize("name", list(constructs.PROBES))
def test_construct_probe_rows_on_cpu(name):
    """Each probe's CPU row: its plain versions agree, nothing is timed,
    and the row says it is plain."""
    row = constructs.PROBES[name](torch.device("cpu"))
    assert row["ok"] and row["verdict"] == "plain (cpu)"
    assert row["route"] == "plain (cpu)"
    assert all(v == "not measured" for k, v in row.items()
               if k.endswith("_ms"))


def test_cluster_probe_plain_layout():
    got = constructs.cluster_probe_plain(4, 2).view(8, 9)
    assert got[:, 0].tolist() == [0, 1, 2, 3] * 2
    assert (got[:, 1:5] == torch.arange(4)).all()
    assert (got[:, 5:] == torch.arange(4)).all()


# ------------------------------------------------------------ kbench blocks

KB_B, KB_IMG, KB_C, KB_H = 2, 4, 64, 2
KB_N = KB_IMG * KB_IMG
LN_SCALES = {"S": (0, 6), "C": (0, 8), "D": (0, 10)}   # norm1, norm2


def _kbench_inputs(attn, seed=0):
    """x (B, N, C), c (B, 16, C), the block's parameters in JAX's (in, out)
    layout (weights N(0, 1) / sqrt(fan-in), biases and the norms' offsets
    N(0, 0.1)), and CPE taps (9, C) / bias, float32."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    x, c = r(KB_B, KB_N, KB_C), r(KB_B, kbench.M, KB_C)
    g = torch.Generator().manual_seed(seed)
    shapes = [tuple(t.shape) for t in kbench.make_params(g, KB_C, attn)]
    params = [r(*s[::-1]) / s[1] ** 0.5 if len(s) == 2 else 0.1 * r(*s)
              for s in shapes]
    for i in LN_SCALES[attn]:
        params[i] += 1
    return x, c, params, 0.3 * r(9, KB_C), 0.1 * r(KB_C)


def _to_torch(params):
    return [torch.from_numpy(p.T.copy() if p.ndim == 2 else p)
            for p in params]


def _xla_cpe(x, taps, bias):
    """train_kbench.py's xla_cpe: a depthwise 3x3 'SAME' convolution."""
    img = x.reshape(KB_B, KB_IMG, KB_IMG, KB_C)
    y = jax.lax.conv_general_dilated(
        img, taps.reshape(3, 3, 1, KB_C), (1, 1), "SAME",
        feature_group_count=KB_C,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return x + (y + bias).reshape(KB_B, KB_N, KB_C)


@pytest.mark.parametrize("with_cpe", [False, True], ids=["no_cpe", "cpe"])
@pytest.mark.parametrize("attn", ["S", "C", "D"])
def test_kbench_plain_block_matches_xla_block(jax_scripts, attn, with_cpe):
    jk = jax_scripts[2]
    x, c, params, taps, bias = _kbench_inputs(attn)
    sx, sc = dca_scales(KB_N, kbench.M, KB_C)
    jx = _xla_cpe(jnp.asarray(x), jnp.asarray(taps), jnp.asarray(bias)) \
        if with_cpe else jnp.asarray(x)
    want = jk.xla_block(jx, jnp.asarray(c), [jnp.asarray(p) for p in params],
                        attn, KB_H, scale_x=sx, scale_c=sc)
    cpe = (torch.from_numpy(taps), torch.from_numpy(bias)) if with_cpe \
        else None
    got = kbench.block("plain", attn, torch.from_numpy(x),
                       torch.from_numpy(c), _to_torch(params), heads=KB_H,
                       scale_x=sx, scale_c=sc, cpe=cpe, img_w=KB_IMG)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, _torch(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cpe_in_kernel", [True, False],
                         ids=["cpe", "cpe_ext"])
@pytest.mark.parametrize("attn", ["D", "S", "C"])
def test_train_kbench_grads_match_jax(jax_scripts, attn, cpe_in_kernel):
    """The training Function's loss and gradients (its plain phases on the
    CPU) against jax.grad of train_kbench.py's xla_loss."""
    jk = jax_scripts[2]
    x, c, params, taps, bias = _kbench_inputs(attn, seed=1)
    sx, sc = dca_scales(KB_N, kbench.M, KB_C)
    jt, jb = jnp.asarray(taps), jnp.asarray(bias)

    def xla_loss(xx, pp):
        out = jk.xla_block(_xla_cpe(xx, jt, jb), jnp.asarray(c), pp, attn,
                           KB_H, scale_x=sx, scale_c=sc)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o.astype(jnp.float32) ** 2) for o in outs) * 1e-6
    jp = [jnp.asarray(p) for p in params]
    want_loss = xla_loss(jnp.asarray(x), jp)
    gx, gp = jax.grad(xla_loss, argnums=(0, 1))(jnp.asarray(x), jp)

    xt = torch.from_numpy(x).requires_grad_()
    pt = [p.requires_grad_() for p in _to_torch(params)]
    loss = train_kbench.block_loss(
        "kernel", attn, xt, torch.from_numpy(c), pt, heads=KB_H, scale_x=sx,
        scale_c=sc, cpe=(torch.from_numpy(taps), torch.from_numpy(bias)),
        img_w=KB_IMG, cpe_in_kernel=cpe_in_kernel)
    grads = torch.autograd.grad(loss, [xt, *pt])
    torch.testing.assert_close(loss, _torch(want_loss), rtol=2e-4,
                               atol=2e-4)
    scale = max(float(jnp.abs(g).max()) for g in [gx, *gp])
    for got, want in zip(grads, [gx, *gp]):
        want = _torch(want)
        if want.dim() == 2:  # JAX's (in, out) weights
            want = want.t()
        torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3 * scale)


def test_fold_matches_folded_params():
    """train_kbench.fold: the LN-folded S block equals the block on the
    unfolded parameters (train_kbench.py::fused_params)."""
    x, c, params, _, _ = _kbench_inputs("S", seed=2)
    pt = _to_torch(params)
    folded = train_kbench.fold(pt, "S")
    dp = torch.ones(4, KB_B)
    got = ft.s_block_train_plain(torch.from_numpy(x), torch.from_numpy(c),
                                 folded, dp, num_heads=KB_H)
    want = kbench.block("plain", "S", torch.from_numpy(x),
                        torch.from_numpy(c), pt, heads=KB_H)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


# -------------------------------------------------------------------- CLIs


def test_kbench_cli_on_cpu(capsys):
    rows = kbench.main(["--device", "cpu", "--batch-size", "1", "--reps",
                        "1", "--stages", "4"])
    assert [r["impl"] for r in rows] == ["plain (cpu)"]
    assert rows[0]["ms_stage"] == pytest.approx(4 * rows[0]["ms_block"])
    staged = kbench.main(["--device", "cpu", "--batch-size", "1", "--reps",
                          "1", "--stages", "4", "--s-stage"])
    assert [r["form"] for r in staged] == ["s_stage", "chain"]
    out = capsys.readouterr().out
    assert "stage4 S N=49 C=512 H=16 plain (cpu)" in out
    assert json.loads(out.strip().splitlines()[-1]) == staged


def test_train_kbench_cli_on_cpu():
    rows = train_kbench.main(["--device", "cpu", "--batch-size", "1",
                              "--reps", "1", "--stages", "4", "--cpe"])
    assert len(rows) == 1 and rows[0]["impl"] == "plain (cpu)"
    assert rows[0]["cpe"] == "in" and rows[0]["grad_ms"] > 0


def test_probes_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "probes.json"
    table = probes_cli.main(["--device", "cpu", "--skip-perf", "--ew",
                             "--out", str(out)])
    assert json.loads(out.read_text()) == table
    for name in probes_cli.CONSTRUCT_PROBES:
        assert table[name]["route"] == "plain (cpu)", table[name]
        assert table[name]["verdict"] == "plain (cpu)"
        assert table[name]["ok"] is True
    assert table["ew"] == probes_cli.NOT_MEASURED
    assert table["launches"] == {} and table["device"] == "plain (cpu)"
    assert "pb_s_stage" not in table
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["erf_prim", "plain", "(cpu)"]


def test_probes_cli_perf_rows_on_cpu(tmp_path, monkeypatch):
    """Without --skip-perf on the CPU the A/B rows and the per-op table
    read "not measured": the CPU gives no device time."""
    monkeypatch.setattr(probes_cli, "run_construct_probe",
                        lambda name, device: {
                            **constructs.PROBES[name](torch.device(device)),
                            "launches": {}})
    table = probes_cli.main(["--device", "cpu", "--ew", "--out",
                             str(tmp_path / "p.json")])
    for name in (*probes_cli.PERF_PROBES, "ew"):
        assert table[name] == probes_cli.NOT_MEASURED
    assert all(table[n]["ok"] for n in probes_cli.CONSTRUCT_PROBES)


@pytest.mark.parametrize("default_ms, switch_ms, word", [
    (100.0, 99.0, "keep"), (100.0, 97.0, "FLIP"), (100.0, 120.0, "keep")])
def test_train_path_row_decides_by_device_ms(default_ms, switch_ms, word):
    """The training paths' verdict comes from the bare steps' device ms,
    not from the CLI runs' host-paced img/s: a switch that is faster by
    more than constructs.NOISE flips, whatever img/s says."""
    runs = ({"img_per_s": 500.0}, {"img_per_s": 400.0})
    row = probes_cli.train_path_row(
        *runs, {"default_ms": default_ms, "switch_ms": switch_ms})
    assert row["verdict"].startswith(word), row["verdict"]
    assert row["verdict"].endswith(" ms)")


def test_train_path_row_without_device_time_decides_nothing():
    row = probes_cli.train_path_row({"img_per_s": 500.0},
                                    {"img_per_s": 900.0},
                                    {"default_ms": None, "switch_ms": 1.0})
    assert row["verdict"].startswith("undecided")


@pytest.mark.parametrize("cli", [probes_cli, kbench, train_kbench])
def test_clis_refuse_without_cuda(monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--device", "cuda"])


def test_probe_entry_points_match_their_signatures():
    kinds = {"int": ctypes.c_int, "void*": ctypes.c_void_p,
             "const void*": ctypes.c_void_p,
             "int*": ctypes.POINTER(ctypes.c_int)}
    found = {}
    for src in _build.sources(probes.CSRC):
        for name, args in re.findall(r'extern "C" int (lm_\w+)\(([^)]*)\)',
                                     src.read_text()):
            found[name] = [kinds[" ".join(a.split()[:-1])]
                           for a in args.split(",")]
    assert found == probes.SIGNATURES


def test_probe_library_builds_apart(tmp_path, monkeypatch):
    """The probes hash only probes/csrc into lemevit_probes_<hash>.so: an
    edited probe renames the probe library, not the model kernels'."""
    for p in probes.CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    model = _build.library_path()
    first = _build.library_path(tmp_path, probes.STEM)
    assert first.name.startswith("lemevit_probes_")
    assert first == _build.library_path(probes.CSRC, probes.STEM)
    assert model.name.startswith("lemevit_kernels_")
    with open(tmp_path / "ew_probe.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path(tmp_path, probes.STEM) != first
    assert _build.library_path() == model


# ------------------------------------------------------------ train_seg


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(tmod, "use_kernel",
                        lambda backend, t: backend != "torch")


class _KeepGrads(torch.optim.Optimizer):
    """An optimizer whose step keeps a copy of every parameter's gradient
    and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self):
        self.grads = [None if p.grad is None else p.grad.clone()
                      for g in self.param_groups for p in g["params"]]


def test_seg_step_with_switch_matches_without(kernel_path, monkeypatch):
    """A micro UperNet seg_train_step with --train-cpe-in-kernel's switch
    equals the step without it in fp32: the loss (2e-4) and the gradient
    of every parameter (1e-5), the CPEs' among them; with it the training
    Functions get the CPEs."""
    from lemevit_tpu_torch.tasks.upernet import create_upernet
    cpes = []
    for name in ("s_block_train", "dca_block_train", "c_block_train"):
        def spy(*a, _f=getattr(ft, name), **kw):
            cpes.append(kw.get("cpe") is not None)
            return _f(*a, **kw)
        monkeypatch.setattr(ft, name, spy)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32))
    mask = torch.from_numpy(rng.randint(0, 3, (2, 32, 32)))
    losses, grads = [], []
    for switch in (False, True):
        cpes.clear()
        model = create_upernet("lemevit_micro", 3, channels=16, device="cpu",
                               train_cpe_in_kernel=switch)
        opt = _KeepGrads(model.parameters())
        losses.append(train_seg.seg_train_step(model, opt, 1e-3, img, mask))
        names = [n for n, _ in model.named_parameters()]
        grads.append(dict(zip(names, opt.grads)))
        assert cpes and all(c == switch for c in cpes)
    torch.testing.assert_close(losses[1], losses[0], rtol=2e-4, atol=2e-4)
    assert any("pos_embed" in n and g is not None
               for n, g in grads[0].items())
    for name, want in grads[0].items():
        got = grads[1][name]
        assert (got is None) == (want is None), name
        if want is not None:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=name)


def test_train_seg_cli_passes_the_switch(tmp_path, monkeypatch):
    from lemevit_tpu_torch.tasks import upernet
    made = []
    real = upernet.create_upernet

    def create(*a, **kw):
        made.append(kw.get("train_cpe_in_kernel"))
        return real(*a, **kw)
    monkeypatch.setattr(upernet, "create_upernet", create)
    for flags in ([], ["--train-cpe-in-kernel"]):
        res = train_seg.main([
            "--synthetic", "--device", "cpu", "--backbone", "lemevit_micro",
            "--crop-size", "32", "--batch-size", "2", "--channels", "16",
            "--iters", "1", "--eval-interval", "1", "--output",
            str(tmp_path / str(len(flags))), *flags])
        assert res["steps"] == 1
    assert made == [False, True]
