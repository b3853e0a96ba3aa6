"""Hub and shard datasets; counterpart of lemevit_tpu/data/iterable.py:
  - WebDatasetFolder: WebDataset-convention tar shards read by random
    access (member offsets indexed once per shard, the stdlib tarfile
    module, no webdataset package), so it is map-style like the others;
    each read is one ``os.pread`` at the member's offset, so the loader's
    threads share a shard's descriptor without a seek between them;
  - HFDataset (hfds/<name>): a HuggingFace ``datasets`` split;
  - TFDSDataset (tfds/<name>): a TensorFlow Datasets split through
    ``tfds.data_source`` (random access, no tf.data graph).

HFDataset and TFDSDataset import their library when built and raise the
JAX package's ImportError without it. Each hands its RGB image to
``transform(img, rng)`` as a PIL image (``get(i, rng)``, as
data/datasets.py's image datasets), else returns it as uint8 HWC.
"""
from __future__ import annotations

import glob
import io
import os
import tarfile
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from lemevit_tpu_torch.data.transforms import Rng, sample_rng

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".ppm", ".bmp")


class _MapDataset:
    """__getitem__(i) = get(i, sample_rng(0, 0, i)); ``get`` applies
    ``transform(img, rng)`` to sample i's image (``_image(i)``: a PIL image
    or an array, made a PIL image for the transform)."""

    transform: Optional[Callable]

    def __getitem__(self, i):
        return self.get(i, sample_rng(0, 0, i))

    def get(self, i: int, rng: Rng):
        from PIL import Image

        img, label = self._image(i)
        if self.transform is not None:
            if not isinstance(img, Image.Image):
                img = Image.fromarray(np.asarray(img, np.uint8))
            return self.transform(img, rng), label
        return np.asarray(img, np.uint8), label


class WebDatasetFolder(_MapDataset):
    """Tar shards (a glob, a directory of .tar, or a list of paths) whose
    members group by key (the name before the extension): an image
    ({key}.jpg, .png, ...) and a label ({key}.cls, an ASCII int; -1
    without). Samples in shard order, keys sorted within a shard."""

    def __init__(self, shards, transform: Optional[Callable] = None,
                 label_ext: str = ".cls"):
        if isinstance(shards, str):
            paths = sorted(glob.glob(os.path.join(shards, "*.tar")) if
                           os.path.isdir(shards) else glob.glob(shards))
        else:
            paths = list(shards)
        if not paths:
            raise FileNotFoundError(f"no .tar shards under {shards!r}")
        self.paths = paths
        self.transform = transform
        # (shard, image offset, image size, label)
        self.index: List[Tuple[int, int, int, int]] = []
        for si, p in enumerate(paths):
            groups: Dict[str, Dict[str, Tuple[int, int]]] = {}
            with tarfile.open(p) as tf:
                for m in tf:
                    if not m.isfile():
                        continue
                    base, ext = os.path.splitext(m.name)
                    groups.setdefault(base, {})[ext.lower()] = (
                        m.offset_data, m.size)
                for base in sorted(groups):
                    g = groups[base]
                    img = next((g[e] for e in IMG_EXTS if e in g), None)
                    if img is None:
                        continue
                    label = -1
                    if label_ext in g:
                        off, size = g[label_ext]
                        tf.fileobj.seek(off)
                        label = int(tf.fileobj.read(size).decode().strip())
                    self.index.append((si, img[0], img[1], label))
        self._fds: Dict[int, int] = {}  # shard -> descriptor, per process
        self._open_lock = threading.Lock()

    def __len__(self):
        return len(self.index)

    def _fd(self, si: int) -> int:
        fd = self._fds.get(si)
        if fd is None:
            with self._open_lock:
                fd = self._fds.get(si)
                if fd is None:
                    fd = self._fds[si] = os.open(self.paths[si], os.O_RDONLY)
        return fd

    def _image(self, i: int):
        from PIL import Image

        si, off, size, label = self.index[i]
        data = os.pread(self._fd(si), size, off)
        if len(data) != size:
            raise EOFError(f"{self.paths[si]}: {len(data)} of {size} bytes "
                           f"at offset {off}")
        return Image.open(io.BytesIO(data)).convert("RGB"), label

    def close(self) -> None:
        with self._open_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __getstate__(self):  # descriptors and the lock are per process
        d = dict(self.__dict__)
        d["_fds"] = {}
        del d["_open_lock"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._open_lock = threading.Lock()


class HFDataset(_MapDataset):
    """A HuggingFace ``datasets`` split, hfds/<name>; ``load_kwargs`` go to
    ``datasets.load_dataset`` (data_dir, cache_dir, ...)."""

    def __init__(self, name: str, split: str = "train",
                 transform: Optional[Callable] = None,
                 image_key: str = "image", label_key: str = "label",
                 **load_kwargs):
        try:
            import datasets as hfds
        except ImportError as e:
            raise ImportError(
                "hfds/ datasets need the `datasets` package (pip install "
                "datasets)") from e
        self.ds = hfds.load_dataset(name, split=split, **load_kwargs)
        self.transform = transform
        self.image_key = image_key
        self.label_key = label_key

    def __len__(self):
        return len(self.ds)

    def _image(self, i: int):
        row = self.ds[int(i)]
        img = row[self.image_key]
        if hasattr(img, "convert"):
            img = img.convert("RGB")
        return img, int(row.get(self.label_key, -1))


class TFDSDataset(_MapDataset):
    """A TensorFlow Datasets split, tfds/<name>."""

    def __init__(self, name: str, split: str = "train",
                 data_dir: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 image_key: str = "image", label_key: str = "label"):
        try:
            import tensorflow_datasets as tfds
        except ImportError as e:
            raise ImportError(
                "tfds/ datasets need the `tensorflow_datasets` package"
            ) from e
        self.src = tfds.data_source(name, split=split, data_dir=data_dir)
        self.transform = transform
        self.image_key = image_key
        self.label_key = label_key

    def __len__(self):
        return len(self.src)

    def _image(self, i: int):
        row = self.src[int(i)]
        return np.asarray(row[self.image_key]), int(row.get(self.label_key,
                                                            -1))


__all__ = ["WebDatasetFolder", "HFDataset", "TFDSDataset"]
