"""PyTorch port, entry points and packaging: the package imports without
JAX, imports nothing of JAX or lemevit_tpu, refuses to carry on on the CPU
unless asked, and its CLIs run on the CPU at a micro size."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import lemevit_tpu_torch
from lemevit_tpu_torch.attn import _build
from lemevit_tpu_torch.cli import benchmark, train, validate

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "lemevit_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|lemevit_tpu(?!_torch))\b",
    re.MULTILINE)


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_imports_without_jax():
    mods = sorted(
        "lemevit_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix(
            "").parts).replace(".__init__", "")
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'flax', 'lemevit_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_package_imports(path):
    src = path.read_text()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)


def test_forbidden_pattern():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from lemevit_tpu.attn import x")
    assert FORBIDDEN.search("    import flax")
    assert not FORBIDDEN.search("from lemevit_tpu_torch.attn import x")
    assert not FORBIDDEN.search("import jaxtyping_free_name_ok")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_create_model_refuses_cpu_fallback(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lemevit_tpu_torch.create_model("lemevit_micro")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lemevit_tpu_torch.create_model("lemevit_micro", device="cuda")
    m = lemevit_tpu_torch.create_model("lemevit_micro", device="cpu")
    assert next(m.parameters()).device.type == "cpu"


@pytest.mark.parametrize("cli", [benchmark, validate, train])
def test_cli_refuses_cpu_fallback(no_cuda, cli):
    argv = ["--model", "lemevit_micro", "--img-size", "32",
            "--batch-size", "2"]
    if cli is not benchmark:
        argv.append("--synthetic")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_benchmark_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "r.json"
    res = benchmark.main(["--model", "lemevit_micro", "--img-size", "32",
                          "--batch-size", "4", "--num-classes", "10",
                          "--num-warm-iter", "1", "--num-bench-iter", "2",
                          "--device", "cpu", "--results-file", str(out)])
    assert json.loads(out.read_text()) == res
    assert res["param_count"] > 0 and res["gmacs"] >= 0
    inf = res["inference"]
    assert inf["batch_size"] == 4 and inf["img_size"] == 32
    assert inf["samples_per_sec"] > 0
    assert "--result" in capsys.readouterr().out


@pytest.mark.parametrize("bench", ["train", "both"])
def test_benchmark_train_on_cpu(bench):
    """--bench train / both return the JAX CLI's result keys."""
    res = benchmark.main(["--model", "lemevit_micro", "--bench", bench,
                          "--img-size", "32", "--batch-size", "2",
                          "--num-classes", "10", "--num-bench-iter", "1",
                          "--device", "cpu"])
    tr = res["train"]
    assert set(tr) == {"samples_per_sec", "step_time", "fwd_time",
                       "bwd_opt_time", "batch_size"}
    assert tr["batch_size"] == 2 and tr["samples_per_sec"] > 0
    assert tr["step_time"] > 0 and tr["fwd_time"] > 0
    assert ("inference" in res) == (bench == "both")
    if bench == "both":
        assert set(res["inference"]) == {"samples_per_sec", "step_time",
                                         "batch_size", "img_size"}


def test_validate_cli_on_cpu(tmp_path):
    res = validate.main(["--model", "lemevit_micro", "--synthetic",
                         "--img-size", "32", "--batch-size", "4",
                         "--num-classes", "10", "--max-batches", "2",
                         "--tta", "--device", "cpu"])
    assert set(res) >= {"top1", "top5", "loss", "samples_per_sec"}
    assert 0 <= res["top1"] <= res["top5"] <= 100
    assert res["loss"] > 0
    with pytest.raises(NotImplementedError):
        validate.main(["--model", "lemevit_micro", "--device", "cpu",
                       "--data-dir", str(tmp_path)])


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    for p in _build.CSRC.glob("*.cu*"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert _build.source_hash() in first.name
    assert first.parent == _build.BUILD_DIR
    with open(tmp_path / "s_block.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != first


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py must exit non-zero and print no result off the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
