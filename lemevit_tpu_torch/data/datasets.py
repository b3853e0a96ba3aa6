"""Datasets: the synthetic dataset of lemevit_tpu/data/datasets.py. The
folder, zip and remote-sensing datasets are not ported yet."""
from __future__ import annotations

import numpy as np


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


def create_dataset(name: str, root: str = "", split: str = "train",
                   **kwargs):
    """Factory with the JAX package's names; only "synthetic" is ported."""
    if name.lower() == "synthetic":
        return SyntheticDataset(**kwargs)
    raise NotImplementedError(
        f"dataset {name!r} is not ported to lemevit_tpu_torch yet "
        "(only 'synthetic')")
