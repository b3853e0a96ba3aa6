"""Packed uint8 sample cache, decoded once and streamed after; counterpart
of lemevit_tpu/data/packed.py.

``pack_folder`` decodes every image of a class-per-directory folder once
(the C++ plane of data/native_decode.py where it loads, PIL per image where
it cannot), takes the centred square of the short side, resamples it
bicubic to ``px`` x ``px`` and writes one (N, px, px, 3) uint8 ``.npy``.
``PackedDataset`` then hands out (uint8 (px, px, 3), label) by memmap, a
memcpy a sample; random resized crops, flips and RandAugment run on the
device over the whole batch (data/device_aug.py).

Train-time crops come from the packed square, not the original frame (see
device_aug.py). Pack at px >= img_size / crop_pct (256 for 224 at 0.875)
so that the eval centre crop frames the image as the reference's resize
and crop do.

Layout: <dir>/images.u8.npy (N x px x px x 3), labels.npy, meta.json.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

META = "meta.json"
IMAGES = "images.u8"
LABELS = "labels.npy"


def pack_folder(src_root: str, out_dir: str, px: int = 256,
                log_every: int = 500) -> dict:
    """Pack the class-per-directory tree ``src_root`` into ``out_dir``;
    returns the meta record (n, px, format, classes)."""
    from lemevit_tpu_torch.data import native_decode as nd
    from lemevit_tpu_torch.data.datasets import ImageFolderDataset, _pil_open

    ds = ImageFolderDataset(src_root)
    n = len(ds)
    os.makedirs(out_dir, exist_ok=True)
    mm = np.lib.format.open_memmap(
        os.path.join(out_dir, IMAGES + ".npy"), mode="w+", dtype=np.uint8,
        shape=(n, px, px, 3))
    labels = np.zeros(n, np.int32)
    native = nd.available()
    for i, (path, label) in enumerate(ds.samples):
        labels[i] = label
        arr = None
        if native:
            with open(path, "rb") as f:
                data = f.read()
            size = nd.jpeg_size(data)
            if size is not None:
                w, h = size
                side = float(min(w, h))
                box = ((w - side) / 2.0, (h - side) / 2.0, side, side)
                arr = nd.decode_crop(data, box, (px, px))
        if arr is None:  # PIL: other formats, CMYK, no library
            img = _pil_open(path)
            w, h = img.size
            side = min(w, h)
            img = img.resize((px, px), 3,  # BICUBIC
                             box=((w - side) / 2, (h - side) / 2,
                                  (w + side) / 2, (h + side) / 2))
            arr = np.asarray(img, np.uint8)
        mm[i] = arr
        if log_every and (i + 1) % log_every == 0:
            print(f"packed {i + 1}/{n}", flush=True)
    mm.flush()
    del mm
    np.save(os.path.join(out_dir, LABELS), labels)
    meta = {"n": n, "px": px, "format": "u8 HWC npy",
            "classes": sorted(ds.class_to_idx, key=ds.class_to_idx.get)}
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f)
    return meta


class PackedDataset:
    """A packed cache: (uint8 (px, px, 3), label) by index. The memmap
    opens on first read in each process, and pickling leaves it behind,
    so spawned loader workers reopen their own."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, META)) as f:
            self.meta = json.load(f)
        self.px = int(self.meta["px"])
        self.labels = np.load(os.path.join(root, LABELS))
        self._mm: Optional[np.ndarray] = None

    def _images(self) -> np.ndarray:
        if self._mm is None:
            self._mm = np.load(os.path.join(self.root, IMAGES + ".npy"),
                               mmap_mode="r")
        return self._mm

    def __len__(self):
        return int(self.meta["n"])

    def __getitem__(self, i) -> Tuple[np.ndarray, int]:
        return np.asarray(self._images()[i]), int(self.labels[i])

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_mm"] = None
        return d
