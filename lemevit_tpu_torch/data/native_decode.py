"""ctypes bindings of the C++ decode plane; counterpart of
lemevit_tpu/data/native_decode.py.

``csrc/leme_data.cpp`` (the port's own copy of the JAX package's
native/leme_data.cpp) decodes JPEG and PNG bytes, crops a box and resamples
it bicubic in C++. ctypes releases the GIL for the whole call, so the
loader's producer threads decode side by side. Every entry point returns
None where the library cannot help (no library, other formats, CMYK,
corrupt bytes), and the caller falls back to PIL.

The library is built at first use with ``g++ ... -ljpeg -lpng`` into
``lemevit_tpu_torch/_build/libleme_data_<hash>.so`` by _native.py (the
hash covers the source, the flags and the host's CPU; a file lock and a
temporary name, so processes that load at once never see half a library).
``available()`` is true only when the library loads; ``require()`` raises
with the compiler's output when it does not.
"""
from __future__ import annotations

import ctypes
import functools
import math
import random
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from lemevit_tpu_torch import _native

SOURCE = Path(__file__).resolve().parent / "csrc" / "leme_data.cpp"
BUILD_DIR = _native.BUILD_DIR
STEM = "leme_data"
LIBS = ("-ljpeg", "-lpng")

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def library_path(source: Path, build_dir: Path) -> Path:
    return _native.library_path(source, build_dir, STEM, LIBS)


def build(source: Path, build_dir: Path) -> Path:
    """Compile ``source`` into its hashed library in ``build_dir`` unless it
    is there; raises RuntimeError with the compiler's output if the build
    fails."""
    return _native.build(source, build_dir, STEM, LIBS)


@functools.lru_cache(maxsize=None)
def _load_from(source: str, build_dir: str) -> tuple:
    """(the loaded library, None) or (None, why it did not load)."""
    try:
        lib = ctypes.CDLL(str(build(Path(source), Path(build_dir))))
    except (RuntimeError, OSError) as e:
        return None, str(e)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    crop_args = [u8p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                 ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, u8p]
    for codec in ("jpeg", "png"):
        size = getattr(lib, f"leme_{codec}_size")
        size.restype = ctypes.c_int
        size.argtypes = [u8p, ctypes.c_int, i32p, i32p]
        crop = getattr(lib, f"leme_{codec}_decode_crop")
        crop.restype = ctypes.c_int
        crop.argtypes = crop_args
    return lib, None


def _load() -> Optional[ctypes.CDLL]:
    return _load_from(str(SOURCE), str(BUILD_DIR))[0]


def available() -> bool:
    """Whether the library built and loads."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library did not build or load (the compiler's output), or
    None when it loads."""
    return _load_from(str(SOURCE), str(BUILD_DIR))[1]


def require() -> None:
    """Raise RuntimeError, quoting the build's output, unless the library
    loads: what an explicit --native-decode asks for."""
    err = build_error()
    if err is not None:
        raise RuntimeError("--native-decode: the native decode library "
                           f"({SOURCE.name}) did not build or load:\n{err}")


def resolve(flag: Optional[bool], auto: bool = True) -> bool:
    """A CLI's --native-decode: None (the default) is on where the library
    loads and ``auto`` allows; True raises, quoting the build's output,
    where it does not load; False is off."""
    if flag is None:
        return auto and available()
    if flag:
        require()
    return bool(flag)


def _codec(lib, data: bytes):
    """(size_fn, decode_fn) for these bytes, or None for neither codec."""
    if len(data) >= 4 and data[:2] == b"\xff\xd8":
        return lib.leme_jpeg_size, lib.leme_jpeg_decode_crop
    if data[:8] == _PNG_MAGIC:
        return lib.leme_png_size, lib.leme_png_decode_crop
    return None


def _u8p(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def jpeg_size(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the header of JPEG or PNG bytes, or None."""
    lib = _load()
    if lib is None or len(data) < 8:
        return None
    codec = _codec(lib, data)
    if codec is None:
        return None
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    if codec[0](_u8p(data), len(data), ctypes.byref(w), ctypes.byref(h)):
        return None
    return int(w.value), int(h.value)



def decode_crop(data: bytes, box: Tuple[float, float, float, float],
                out_size: Tuple[int, int],
                hflip: bool = False) -> Optional[np.ndarray]:
    """Decode JPEG / PNG bytes, crop box = (x0, y0, cw, ch) in the image's
    coordinates, resample bicubic to out_size = (w, h): uint8 RGB HWC, or
    None when the caller must fall back to PIL."""
    lib = _load()
    if lib is None or len(data) < 8:
        return None
    codec = _codec(lib, data)
    if codec is None:
        return None
    ow, oh = out_size
    out = np.empty((oh, ow, 3), np.uint8)
    rc = codec[1](_u8p(data), len(data), float(box[0]), float(box[1]),
                  float(box[2]), float(box[3]), int(ow), int(oh),
                  int(bool(hflip)),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return None if rc != 0 else out


def rrc_box(w: int, h: int, rng: random.Random, scale=(0.08, 1.0),
            ratio=(3 / 4, 4 / 3)) -> Tuple[float, float, float, float]:
    """timm's RandomResizedCrop box, drawn from ``rng`` (a transforms.Rng's
    ``py``) with the JAX function's calls in its order, so that
    ``Rng.from_seed(s)`` gives the boxes ``random.seed(s)`` gives JAX."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw)
            y0 = rng.randint(0, h - ch)
            return (float(x0), float(y0), float(cw), float(ch))
    side = min(w, h)
    return ((w - side) / 2.0, (h - side) / 2.0, float(side), float(side))


def center_box(w: int, h: int, size: int, crop_pct: float = 0.9
               ) -> Tuple[float, float, float, float]:
    """The source box of a resize of the short side to size / crop_pct and
    a centred size x size crop, as one crop-then-resize; draws nothing."""
    short = min(w, h)
    crop_src = short * size / float(int(math.floor(size / crop_pct)))
    return ((w - crop_src) / 2.0, (h - crop_src) / 2.0, crop_src, crop_src)
