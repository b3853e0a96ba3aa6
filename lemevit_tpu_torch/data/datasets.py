"""Datasets, counterpart of lemevit_tpu/data/datasets.py:
  - ImageFolderDataset: class-per-subdirectory, with byte caching
    (cache_mode 'no' / 'full' / 'part', the last rank-strided);
  - ManifestDataset and the remote-sensing manifests MillionAID / UCM /
    AID / NWPU-RESISC: ``<name> <class>`` lines under an image folder;
  - ZipImageFolder: images inside a zip with an annotation file, read
    through ZipReader (``archive.zip@inner/path``), a corrupt image
    replaced by random pixels;
  - SyntheticDataset: seeded random images for benchmarks and tests;
  - CDPairDataset: change-detection pairs, {split}/A, {split}/B and
    {split}/OUT images of one name each.

A dataset has __len__ and __getitem__ -> (uint8 HWC image or PIL image,
int label). The image datasets also have ``get(i, rng)``, which hands the
sample's generators (transforms.Rng) to the transform and to the zip
fallback; __getitem__(i) is get(i, sample_rng(0, 0, i)). The loader calls
``load_sample(dataset, i, seed, epoch)``, which takes ``get`` where there
is one.

create_dataset also routes the hub and shard names (hfds/<name>,
tfds/<name>, wds and wds/<shards>) to data/iterable.py, and the
change-detection names (cdd, levir, cd_pairs) to CDPairDataset.
"""
from __future__ import annotations

import io
import os
import threading
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from lemevit_tpu_torch.data.transforms import Rng, sample_rng

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


def _pil_open(path_or_bytes) -> Image.Image:
    """A file path or encoded bytes -> an RGB PIL image."""
    if isinstance(path_or_bytes, bytes):
        img = Image.open(io.BytesIO(path_or_bytes))
    else:
        img = Image.open(path_or_bytes)
    return img.convert("RGB")


def load_sample(dataset, i: int, seed: int = 0, epoch: int = 0):
    """Sample ``i`` of ``dataset`` in ``epoch`` of a run seeded ``seed``:
    ``get(i, sample_rng(seed, epoch, i))`` where the dataset takes
    generators, else ``dataset[i]``."""
    get = getattr(dataset, "get", None)
    return dataset[i] if get is None else get(i, sample_rng(seed, epoch, i))


class _ImageDataset:
    """__getitem__ over ``get``; ``transform(img, rng)`` applied to the
    decoded image, or to the encoded bytes where it sets ``wants_encoded``
    (a hook for a decoder of its own)."""

    samples: List[Tuple[str, int]]
    transform: Optional[Callable]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.get(i, sample_rng(0, 0, i))

    def _encoded(self, i: int) -> bytes:
        with open(self.samples[i][0], "rb") as f:
            return f.read()

    def _image(self, i: int, rng: Rng):
        return _pil_open(self.samples[i][0])

    def get(self, i: int, rng: Rng):
        label = self.samples[i][1]
        if self.transform is not None and getattr(
                self.transform, "wants_encoded", False):
            return self.transform(self._encoded(i), rng), label
        img = self._image(i, rng)
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, label


class ImageFolderDataset(_ImageDataset):
    """Class-per-subdirectory layout, classes in sorted order.

    cache_mode: 'no' reads every access from disk; 'full' keeps every
    file's bytes in memory from construction; 'part' keeps this rank's
    stride of them (rank, rank + world_size, ...)."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 class_map: Optional[Dict[str, int]] = None,
                 cache_mode: str = "no", rank: int = 0,
                 world_size: int = 1):
        self.root = root
        self.transform = transform
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = class_map or {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTS):
                    self.samples.append(
                        (os.path.join(cdir, fn), self.class_to_idx[c]))
        self._bytes: Dict[int, bytes] = {}
        if cache_mode in ("full", "part"):
            step = 1 if cache_mode == "full" else world_size
            start = 0 if cache_mode == "full" else rank
            for i in range(start, len(self.samples), step):
                self._bytes[i] = super()._encoded(i)

    def _encoded(self, i: int) -> bytes:
        data = self._bytes.get(i)
        return super()._encoded(i) if data is None else data

    def _image(self, i: int, rng: Rng):
        return _pil_open(self._bytes.get(i, self.samples[i][0]))


class ManifestDataset(_ImageDataset):
    """A labels file of ``<relpath-or-name> <class>`` lines and an image
    folder: the reference's MillionAID / UCM / AID / NWPU loaders, which
    differ only in the file names."""

    manifest_train = "train_labels.txt"
    manifest_val = "valid_labels.txt"
    img_subdir = "all_img"

    def __init__(self, root: str, split: str = "train",
                 transform: Optional[Callable] = None,
                 manifest: Optional[str] = None):
        self.root = root
        self.transform = transform
        mf = manifest or (self.manifest_train if split == "train"
                          else self.manifest_val)
        self.samples = []
        with open(os.path.join(root, mf)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name, _, label = line.rpartition(" ")
                self.samples.append(
                    (os.path.join(root, self.img_subdir, name), int(label)))


class MillionAIDDataset(ManifestDataset):
    pass


class UCMDataset(ManifestDataset):
    manifest_train = "train_labels_55.txt"
    manifest_val = "valid_labels_55.txt"


class AIDDataset(ManifestDataset):
    manifest_train = "train_labels_55.txt"
    manifest_val = "valid_labels_55.txt"


class NWPURESISCDataset(ManifestDataset):
    manifest_train = "train_labels_19.txt"
    manifest_val = "valid_labels_19.txt"


class ZipReader:
    """Reads ``archive.zip@inner/path`` through one open handle per archive
    (zipfile serialises reads on a handle); an image that does not decode
    becomes fallback_size² random pixels from the sample's generator."""

    def __init__(self):
        self._handles: Dict[str, zipfile.ZipFile] = {}
        self._lock = threading.Lock()

    @staticmethod
    def split_path(path: str) -> Tuple[str, str]:
        if "@" not in path:
            raise ValueError(f"zip path must be 'x.zip@inner', got {path!r}")
        zip_path, _, inner = path.partition("@")
        return zip_path, inner

    def handle(self, zip_path: str) -> zipfile.ZipFile:
        with self._lock:
            zf = self._handles.get(zip_path)
            if zf is None:
                zf = self._handles[zip_path] = zipfile.ZipFile(zip_path)
            return zf

    def read(self, path: str) -> bytes:
        zip_path, inner = self.split_path(path)
        return self.handle(zip_path).read(inner)

    def imread(self, path: str, rng: Rng, fallback_size: int = 224):
        try:
            return _pil_open(self.read(path))
        except (OSError, SyntaxError, EOFError, ValueError, KeyError,
                zipfile.BadZipFile):
            # what PIL raises for bytes that do not decode (OSError and
            # UnidentifiedImageError, SyntaxError for a broken PNG), and
            # zipfile for a missing (KeyError) or damaged member
            arr = rng.np.randint(0, 256, (fallback_size, fallback_size, 3),
                                 dtype=np.uint8)
            return Image.fromarray(arr)

    def close(self) -> None:
        with self._lock:
            for zf in self._handles.values():
                zf.close()
            self._handles.clear()


class ZipImageFolder(_ImageDataset):
    """Images inside a zip, listed by an annotation file of
    ``inner/path<TAB or space>class`` lines (the reference's zip mode)."""

    def __init__(self, zip_path: str, ann_file: str,
                 transform: Optional[Callable] = None):
        self.zip_path = zip_path
        self.transform = transform
        self.reader = ZipReader()
        self.reader.handle(zip_path)  # a missing archive raises here
        self.samples = []
        with open(ann_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name, _, label = line.rpartition("\t" if "\t" in line else " ")
                self.samples.append((name, int(label)))

    def _encoded(self, i: int) -> bytes:
        return self.reader.read(f"{self.zip_path}@{self.samples[i][0]}")

    def _image(self, i: int, rng: Rng):
        return self.reader.imread(f"{self.zip_path}@{self.samples[i][0]}",
                                  rng)


class SyntheticDataset:
    """Deterministic random uint8 images (HWC) and labels, one RandomState
    per index: the same samples as the JAX package's SyntheticDataset."""

    def __init__(self, num_samples: int = 1024, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0):
        self.num_samples = num_samples
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        img = rng.randint(0, 256, (self.image_size, self.image_size, 3),
                          dtype=np.uint8)
        return img, int(rng.randint(self.num_classes))


class CDPairDataset:
    """Change-detection pairs: {split}/A/<name>, {split}/B/<name> and the
    binary mask {split}/OUT/<name>, for the image names of A in sorted
    order. A sample is ((image A, image B) as RGB PIL images, mask as an
    "L" PIL image), through ``transform(a, b, mask)`` where one is given
    (the JAX package's CDPairDataset)."""

    def __init__(self, root: str, split: str = "train",
                 transform: Optional[Callable] = None):
        self.dir_a = os.path.join(root, split, "A")
        self.dir_b = os.path.join(root, split, "B")
        self.dir_m = os.path.join(root, split, "OUT")
        self.names = sorted(fn for fn in os.listdir(self.dir_a)
                            if fn.lower().endswith(IMG_EXTS))
        self.transform = transform

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        n = self.names[i]
        a = _pil_open(os.path.join(self.dir_a, n))
        b = _pil_open(os.path.join(self.dir_b, n))
        m = Image.open(os.path.join(self.dir_m, n)).convert("L")
        if self.transform:
            a, b, m = self.transform(a, b, m)
        return (a, b), m


def create_dataset(name: str, root: str = "", split: str = "train",
                   transform: Optional[Callable] = None, **kwargs):
    """The JAX package's factory, with its names. 'wds' reads the tar
    shards of ``<root>/<split>`` (or ``shards=``), 'wds/<glob>' without a
    root those of the glob. 'zipfolder' takes
    ``zip_path`` and ``ann_file``, or reads ``<root>/<split>.zip`` with
    ``<root>/<split>_map.txt`` (the reference's zip layout)."""
    name = name.lower()
    if name.startswith("hfds/"):
        from lemevit_tpu_torch.data.iterable import HFDataset
        return HFDataset(name[5:], split=split, transform=transform,
                         **kwargs)
    if name.startswith("tfds/"):
        from lemevit_tpu_torch.data.iterable import TFDSDataset
        return TFDSDataset(name[5:], split=split, data_dir=root or None,
                           transform=transform, **kwargs)
    if name.startswith("wds/") or name == "wds":
        from lemevit_tpu_torch.data.iterable import WebDatasetFolder
        shards = kwargs.pop("shards", None)
        if shards is None:
            shards = os.path.join(root, split) if root else name[4:]
        return WebDatasetFolder(shards, transform=transform, **kwargs)
    if name in ("cdd", "levir", "cd_pairs"):
        return CDPairDataset(root, split=split, transform=transform)
    table = {
        "millionaid": MillionAIDDataset,
        "torch/millionaid": MillionAIDDataset,
        "ucm": UCMDataset,
        "aid": AIDDataset,
        "nwpu": NWPURESISCDataset,
        "nwpu_resisc45": NWPURESISCDataset,
    }
    if name in table:
        return table[name](root, split=split, transform=transform)
    if name in ("synthetic", "fake"):
        return SyntheticDataset(**kwargs)
    if name in ("imagefolder", "folder", "image_folder", ""):
        split_dir = os.path.join(root, split)
        return ImageFolderDataset(
            split_dir if os.path.isdir(split_dir) else root,
            transform=transform)
    if name == "zipfolder":
        kwargs.setdefault("zip_path", os.path.join(root, f"{split}.zip"))
        kwargs.setdefault("ann_file", os.path.join(root, f"{split}_map.txt"))
        return ZipImageFolder(transform=transform, **kwargs)
    raise ValueError(f"unknown dataset {name!r}")
