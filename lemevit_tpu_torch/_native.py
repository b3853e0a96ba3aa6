"""Builds the port's host-side C++ libraries (data/native_decode.py's
``leme_data``, ops/native.py's ``leme_ops``) at first use.

A library is compiled with the JAX package's native/Makefile flags into
``lemevit_tpu_torch/_build/lib<stem>_<hash>.so`` (git-ignored). The hash
covers the source, the flags, the libraries linked and the host's CPU (the
build is for ``-march=native``). The build writes a temporary name and
moves it into place under a file lock per library, so processes that load
at once never see half a library.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX = "g++"
# the JAX package's native/Makefile flags, so that both builds give the
# same bits
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-march=native", "-shared"]
BUILD_TIMEOUT_S = 300


def _host_key() -> str:
    """The CPU the build is for: the machine and its feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")),
                         "")
    except OSError:
        pass
    return platform.machine() + flags


def library_path(source: Path, build_dir: Path, stem: str,
                 libs: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS, *libs]).encode())
    h.update(_host_key().encode())
    h.update(source.read_bytes())
    return build_dir / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path, stem: str,
          libs: Sequence[str]) -> Path:
    """Compile ``source`` (linked with ``libs``) into its hashed library
    ``lib<stem>_<hash>.so`` in ``build_dir`` unless it is there; raises
    RuntimeError with the compiler's output if the build fails."""
    so = library_path(source, build_dir, stem, libs)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"lib{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # built by another process while this one waited
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            cmd = [CXX, *CXX_FLAGS, "-o", tmp, str(source), *libs]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"$ {' '.join(cmd)}\n{e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"$ {' '.join(cmd)}\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so
