"""Build and load the hand-written CUDA kernels under ``attn/csrc``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library's name carries a hash of the sources and flags, so an edited source
builds anew and a stale library is never loaded. Builds go to
``lemevit_tpu_torch/_build/`` (git-ignored). Nothing but the repository's own
sources is compiled.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PTRS = ctypes.POINTER(ctypes.c_void_p)
# entry point -> argtypes (every entry returns a cudaError_t code)
SIGNATURES = {
    "lm_c_block": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "lm_dca_block": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                     _P],
    "lm_s_block": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "lm_s_stage": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                   _P],
    "lm_s_train_fwd": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "lm_mlp_bwd": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _F, _P],
    "lm_s_attn_bwd": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                      _P],
    "lm_dca_train_fwd": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                         _F, _P],
    "lm_dca_attn_bwd": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                        _F, _F, _P],
    "lm_c_train_fwd": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                       _P],
    "lm_c_attn_bwd": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                      _P],
    "lm_dca_attn": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                    _F, _P],
    "lm_mhsa": [_I, _PTRS, _I, _I, _I, _I, _I, _I, _F, _P],
}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from attn/csrc at first use")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"lemevit_kernels_{source_hash()}.so"


def _run_all(cmds, what: str) -> None:
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
             for c in cmds]
    failed = []
    for c, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(c)}\n{out}{err}")
    if failed:
        raise RuntimeError(f"{what} failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile csrc/ into the hashed library unless it already exists."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)] for src, obj in zip(sources(), objs)],
                 "nvcc compile")
        tmp_so = tmp / so.name
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp_so),
                   *map(str, objs)]], "nvcc link")
        os.replace(tmp_so, so)  # atomic: a reader never sees half a file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lm_error_string.argtypes = [ctypes.c_int]
    lib.lm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.lm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
