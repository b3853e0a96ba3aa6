"""ctypes bindings of the host-ops library; counterpart of
lemevit_tpu/ops/native.py, with its API (``available``, ``version``,
``nms``, ``soft_nms``, ``box_iou_rotated``, ``obb_nms``; numpy in, numpy
out).

``csrc/leme_ops.cpp`` is the port's own copy of the JAX package's
native/leme_ops.cpp: NMS and rotated IoU in C++ for the eval's host-side
post-processing (tasks/map_eval.py). It needs only the C++ standard
library. It is built at first use by _native.py, as the decode library
is (``g++ -O3 ... -march=native``, under a file lock, written to a
temporary name and moved into place), into
``lemevit_tpu_torch/_build/libleme_ops_<hash>.so`` (git-ignored; the hash
covers the source, the flags and the host's CPU), never through the JAX
package's ``make -C native``. Where it does not build or load, every
function falls back to the port's own torch ops (ops/boxes.py,
ops/rotated.py) on the CPU, as the JAX package falls back to its jnp ops.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from lemevit_tpu_torch import _native

SOURCE = Path(__file__).resolve().parent / "csrc" / "leme_ops.cpp"
BUILD_DIR = _native.BUILD_DIR
STEM = "leme_ops"


def library_path(source: Path, build_dir: Path) -> Path:
    return _native.library_path(source, build_dir, STEM, ())


@functools.lru_cache(maxsize=None)
def _load_from(source: str, build_dir: str) -> tuple:
    """(the loaded library, None) or (None, why it did not load)."""
    try:
        so = _native.build(Path(source), Path(build_dir), STEM, ())
        lib = ctypes.CDLL(str(so))
    except (RuntimeError, OSError) as e:
        return None, str(e)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.leme_nms.restype = ctypes.c_int
    lib.leme_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float, i32p]
    lib.leme_soft_nms.restype = None
    lib.leme_soft_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_int,
                                  ctypes.c_float]
    lib.leme_box_iou_rotated.restype = None
    lib.leme_box_iou_rotated.argtypes = [f32p, ctypes.c_int, f32p,
                                         ctypes.c_int, ctypes.c_int, f32p]
    lib.leme_obb_nms.restype = ctypes.c_int
    lib.leme_obb_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, i32p]
    lib.leme_version.restype = ctypes.c_char_p
    return lib, None


def _load() -> Optional[ctypes.CDLL]:
    return _load_from(str(SOURCE), str(BUILD_DIR))[0]


def available() -> bool:
    """Whether the library built and loads."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library did not build or load, or None when it loads."""
    return _load_from(str(SOURCE), str(BUILD_DIR))[1]


def version() -> str:
    lib = _load()
    if lib is None:
        return "unavailable"
    return lib.leme_version().decode()


def _f32(a, width: int = 0) -> np.ndarray:
    """A C-contiguous float32 copy the library may read; with ``width``,
    rows of that many values (raises on another shape)."""
    out = np.ascontiguousarray(np.asarray(a), dtype=np.float32)
    if width and (out.ndim != 2 or out.shape[1] != width):
        raise ValueError(f"expected (N, {width}) boxes, got {out.shape}")
    return out


def _scores(scores, boxes: np.ndarray) -> np.ndarray:
    out = _f32(scores)
    if out.shape != (len(boxes),):
        raise ValueError(f"expected ({len(boxes)},) scores, got {out.shape}")
    return out


def _ptr(a: np.ndarray, ctype=ctypes.c_float):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def nms(boxes, scores, iou_threshold: float = 0.5) -> np.ndarray:
    """Host NMS of xyxy boxes. Returns the bool keep mask (N,)."""
    lib = _load()
    boxes = _f32(boxes, 4)
    scores = _scores(scores, boxes)
    if lib is None:
        from lemevit_tpu_torch.ops.boxes import nms as tnms
        return tnms(torch.from_numpy(boxes), torch.from_numpy(scores),
                    iou_threshold).numpy()
    keep = np.zeros(len(boxes), np.int32)
    lib.leme_nms(_ptr(boxes), _ptr(scores), len(boxes), iou_threshold,
                 _ptr(keep, ctypes.c_int32))
    return keep.astype(bool)


def soft_nms(boxes, scores, iou_threshold: float = 0.3, sigma: float = 0.5,
             method: str = "linear",
             score_threshold: float = 1e-3) -> np.ndarray:
    """Host soft-NMS; returns the decayed scores (N,)."""
    lib = _load()
    boxes = _f32(boxes, 4)
    scores = _scores(scores, boxes).copy()
    if lib is None:
        from lemevit_tpu_torch.ops.boxes import soft_nms as tsoft
        return tsoft(torch.from_numpy(boxes), torch.from_numpy(scores),
                     iou_threshold, sigma, method, score_threshold).numpy()
    lib.leme_soft_nms(_ptr(boxes), _ptr(scores), len(boxes), iou_threshold,
                      sigma, 1 if method == "gaussian" else 0,
                      score_threshold)
    return scores


def box_iou_rotated(a, b, mode: str = "iou") -> np.ndarray:
    """Pairwise rotated IoU (or IoF) of (N, 5) and (M, 5) -> (N, M)."""
    lib = _load()
    a = _f32(a, 5)
    b = _f32(b, 5)
    if lib is None:
        from lemevit_tpu_torch.ops.rotated import box_iou_rotated as trot
        return trot(torch.from_numpy(a), torch.from_numpy(b),
                    mode=mode).numpy()
    out = np.zeros((len(a), len(b)), np.float32)
    lib.leme_box_iou_rotated(_ptr(a), len(a), _ptr(b), len(b),
                             1 if mode == "iof" else 0, _ptr(out))
    return out


def obb_nms(boxes, scores, iou_threshold: float = 0.1,
            min_size: float = 1e-2) -> np.ndarray:
    """Host rotated NMS of (N, 5); returns the bool keep mask (N,)."""
    lib = _load()
    boxes = _f32(boxes, 5)
    scores = _scores(scores, boxes)
    if lib is None:
        from lemevit_tpu_torch.ops.rotated import obb_nms as tobb
        return tobb(torch.from_numpy(boxes), torch.from_numpy(scores),
                    iou_threshold, min_size).numpy()
    keep = np.zeros(len(boxes), np.int32)
    lib.leme_obb_nms(_ptr(boxes), _ptr(scores), len(boxes), iou_threshold,
                     min_size, _ptr(keep, ctypes.c_int32))
    return keep.astype(bool)
