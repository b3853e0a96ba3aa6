"""Hopper toolchain probes: the counterparts of the TPU probe kernels of
``scripts/mosaic_probes.py`` (the Mosaic construct probes) and
``scripts/vpu_probe.py`` (the per-op cost probe).

The kernels live in ``probes/csrc/*.cu`` and build, at first use, into their
own library ``lemevit_tpu_torch/_build/lemevit_probes_<hash>.so`` (by
``attn/_build.py``, apart from the model kernels' library: editing a probe
does not rebuild the model kernels, and a probe that does not compile does
not stop them from building). ``ew.py`` holds the per-op probe,
``constructs.py`` the construct probes; ``cli/probes.py`` runs them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from lemevit_tpu_torch.attn import _build

CSRC = Path(__file__).resolve().parent / "csrc"
STEM = "lemevit_probes"

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (every entry returns a cudaError_t code)
SIGNATURES = {
    "lm_ew_probe": [_I, _I, _P, _P, _I, _I, _P],
    "lm_ew_layout": [_I, ctypes.POINTER(ctypes.c_int)],
    "lm_erf_probe": [_I, _I, _P, _P, _I, _I, _P],
    "lm_scatter_add_probe": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "lm_roll_rows_probe": [_P, _P, _I, _I, _I, _P],
    "lm_fold_probe": [_P, _P, _I, _I, _P],
    "lm_cluster_probe": [_I, _I, _P, _P],
    "lm_cluster_occupancy": [_I, ctypes.POINTER(ctypes.c_int)],
}


def build() -> Path:
    """Compile probes/csrc into its hashed library unless it exists."""
    return _build.build(CSRC, STEM)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded probe library (built on first call)."""
    return _build.load(build(), SIGNATURES)


def launch(name: str, like: torch.Tensor, *args, counts: dict,
           key: str = None) -> None:
    """Run entry point lm_<name>(*args, stream) on like's device and current
    stream, raise on a CUDA error, and add one to counts[key or name].
    Tensors in args pass as their data pointers."""
    args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    _build.launch(library(), name, like.device, *args, counts=counts,
                  key=key)


def check_cuda(name: str, *tensors, dtype=None) -> None:
    """Raise unless every tensor lies on one CUDA device, is contiguous and
    16-byte aligned, and (with ``dtype``) has that type."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: tensor {i} is on {t.device}, "
                             f"expected {dev}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: tensor {i} is {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor {i} is not contiguous and "
                             "16-byte aligned")
